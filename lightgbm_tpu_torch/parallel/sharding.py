"""Meshes of ranks, placement rules and the mesh's collectives.

Port of ``lightgbm_tpu/parallel/sharding.py``.  The JAX package runs one
single-controller program over a ``jax.sharding.Mesh`` of devices; the port
runs the same SPMD program as one process per rank over a
``torch.distributed`` process group, and ``Mesh`` is that group seen as a
grid with named axes:

  * ``make_mesh`` / ``mesh_for_config`` build 1-D or 2-D meshes over the
    group's ranks (``parallel_mesh="2x2"`` is data x feature); rank r sits
    at the row-major grid coordinate of r, the JAX package's
    ``np.asarray(devices).reshape(shape)``;
  * each axis has one sub-group per line of the grid (``dist.new_group``),
    so a collective over the ``data`` axis runs among the ranks that share
    the feature coordinate;
  * ``psum`` / ``pmax`` / ``psum_scatter`` / ``all_gather`` are the
    counterparts of ``lax.psum``, ``lax.pmax``, ``lax.psum_scatter(tiled)``
    and ``lax.all_gather``; every call is counted in ``calls`` / ``bytes``,
    and, when a list is set on ``log`` (off by default), recorded in order
    as (op, axis, dtype, payload bytes, calling site): the record the
    analysis gate's ``programs`` pass pins;
  * ``PlacementRules`` / ``rules_for_mode`` keep the JAX package's regex
    tables; ``place`` returns this rank's block of a global array.

Transports.  NCCL takes CUDA tensors as they are.  gloo takes CPU tensors;
a CUDA tensor given to a gloo mesh (several ranks on one card, where NCCL
refuses) is copied to a host buffer, reduced there and copied back: the
``host-staged`` transport, which ``transport()`` names.  Neither backend
reduces int16, so the quantized histograms' int16 tier travels as packed
int32 words (``ops/quant.py:pack_hist_words``).
"""

from __future__ import annotations

import os
import re
import sys
import time
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FEATURE = "feature"
#: the ``tree_learner`` values that shard
PARALLEL_MODES = ("data", "feature", "voting", "data_feature")


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    """Ranks of the default process group (1 when none is initialized)."""
    return _world()[1]


def is_primary() -> bool:
    """Rank 0 of the process group, or the only process: the one that
    writes the model (every rank holds the same trees)."""
    return _world()[0] == 0


def card_id(device) -> Optional[str]:
    """The identity of the card ``device`` names (its UUID), or None for a
    CPU device: two ranks whose ids are equal share one card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return str(torch.cuda.get_device_properties(index).uuid)


def default_backend(cards: Sequence[Optional[str]]) -> str:
    """The backend of a world whose ranks train on ``cards`` (one entry a
    rank, ``card_id``'s): NCCL only when every rank has a card and no two
    share one; gloo otherwise (the CPU, or several ranks on one card, which
    NCCL refuses)."""
    cards = list(cards)
    if cards and all(cards) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def init_group(store, rank: int, world: int, device,
               timeout: timedelta) -> str:
    """Join rank ``rank`` of a ``world``-rank process group on ``store``:
    every rank posts its card (``card_id``) to the store first, and all of
    them take ``default_backend`` of the posted cards, so the choice is the
    world's, the same on every rank.  Returns the backend."""
    from torch.distributed import PrefixStore
    cards = PrefixStore("lgbt-cards", store)
    cards.set(f"r{rank}", card_id(device) or "")
    keys = [f"r{r}" for r in range(world)]
    cards.wait(keys, timeout)
    backend = default_backend(
        [cards.get(k).decode() or None for k in keys])
    if backend == "nccl":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, store=PrefixStore("lgbt-pg", store),
                            rank=rank, world_size=world, timeout=timeout)
    return backend


def group_timeout(cfg) -> timedelta:
    """The process group's (and a pod store's) timeout: ``time_out``
    minutes."""
    return timedelta(minutes=max(int(getattr(cfg, "time_out", 120) or 120),
                                 1))


def init_from_env(cfg, device) -> None:
    """Join the process group a launcher describes in the environment
    (``torchrun`` sets ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``), unless one is initialized or the world is one rank:
    the ``env://`` rendezvous's store, ``init_group`` on it, with
    ``time_out`` minutes as the collectives' timeout."""
    import os
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or (dist.is_available() and dist.is_initialized()):
        return
    timeout = group_timeout(cfg)
    store, rank, world = next(dist.rendezvous("env://", timeout=timeout))
    init_group(store, rank, world, device, timeout)


class Mesh:
    """The process group's ranks as a grid with named axes (see the module
    docstring).  Every rank builds the same mesh, in the same order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"axis_names {self.axis_names} does not match "
                             f"mesh shape {self.shape}")
        self.size = int(np.prod(self.shape))
        self.rank, world = _world()
        if self.size != world:
            raise ValueError(f"mesh shape {self.shape} needs {self.size} "
                             f"ranks, the process group has {world}")
        self.coords = tuple(int(c) for c in
                            np.unravel_index(self.rank, self.shape))
        self.backend = dist.get_backend() if world > 1 else None
        #: collectives issued, their payload bytes, and the host seconds
        #: spent in them: the waits for the peers, and with the host-staged
        #: transport the copies, which first wait for the card's queued work
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0
        #: the ordered collective record: None (the default) records
        #: nothing; a list gets one ``log_entry`` per collective issued
        self.log: Optional[list] = None
        self._groups = {}
        grid = np.arange(self.size).reshape(self.shape)
        for i, name in enumerate(self.axis_names):
            if world == 1 or self.shape[i] == 1:
                self._groups[name] = None
            elif len(self.shape) == 1:
                self._groups[name] = dist.group.WORLD
            else:
                lines = np.moveaxis(grid, i, -1).reshape(-1, self.shape[i])
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if self.rank in line:
                        self._groups[name] = g

    # -- geometry ------------------------------------------------------------

    def axis_size(self, axis: Optional[str] = None) -> int:
        if axis is None:
            return self.size
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]

    def transport(self, device) -> str:
        """How a collective of tensors on ``device`` travels."""
        if self.size == 1:
            return "none"
        if self.backend == "gloo" and torch.device(device).type == "cuda":
            return "host-staged"
        return "direct"

    def _group(self, axis: Optional[str]):
        if axis is None:
            return dist.group.WORLD if self.size > 1 else None
        return self._groups[axis]

    # -- collectives ---------------------------------------------------------

    def _stage(self, x: torch.Tensor, fresh: bool = False):
        """(operand, home): a CUDA tensor of a gloo mesh copied into a
        pinned host buffer, and the device it goes back to; else the tensor
        itself (a copy with ``fresh``: ``all_reduce`` writes in place) and
        None."""
        if self.backend == "gloo" and x.is_cuda:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x)
            return buf, x.device
        x = x.contiguous()
        return (x.clone() if fresh else x), None

    def _count(self, x: torch.Tensor, op: str, axis) -> float:
        self.calls += 1
        self.bytes += int(x.numel()) * int(x.element_size())
        if self.log is not None:
            self.log.append(log_entry(op, axis, x))
        return time.perf_counter()

    def _reduce(self, x: torch.Tensor, axis, op) -> torch.Tensor:
        g = self._group(axis)
        if g is None:
            return x
        t0 = self._count(x, "pmax" if op == dist.ReduceOp.MAX else "psum",
                         axis)
        y, home = self._stage(x, fresh=True)
        dist.all_reduce(y, op=op, group=g)
        y = y if home is None else y.to(home)
        self.seconds += time.perf_counter() - t0
        return y

    def psum(self, x: torch.Tensor, axis: Optional[str] = None
             ) -> torch.Tensor:
        """Sum over the ranks of ``axis`` (all axes for None)."""
        return self._reduce(x, axis, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axis: Optional[str] = None
             ) -> torch.Tensor:
        """Elementwise maximum over the ranks of ``axis``."""
        return self._reduce(x, axis, dist.ReduceOp.MAX)

    def psum_scatter(self, x: torch.Tensor, axis: str, dim: int = 0
                     ) -> torch.Tensor:
        """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
        the sum over the axis, of which this rank keeps block
        ``axis_index(axis)`` of dimension ``dim``."""
        g = self._group(axis)
        if g is None:
            return x
        t0 = self._count(x, "psum_scatter", axis)
        d = self.axis_size(axis)
        if x.shape[dim] % d:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {d} ranks")
        xm = x.movedim(dim, 0)
        y, home = self._stage(xm)
        out = torch.empty((y.shape[0] // d,) + tuple(y.shape[1:]),
                          dtype=y.dtype, device=y.device)
        dist.reduce_scatter_tensor(out, y, group=g)
        if home is not None:
            out = out.to(home)
        self.seconds += time.perf_counter() - t0
        return out.movedim(0, dim)

    def all_gather(self, x: torch.Tensor, axis: Optional[str] = None
                   ) -> torch.Tensor:
        """``lax.all_gather``: (ranks of the axis,) + x.shape, in rank order
        (for None, the whole mesh in row-major grid order)."""
        g = self._group(axis)
        if g is None:
            return x[None]
        t0 = self._count(x, "all_gather", axis)
        d = self.axis_size(axis)
        y, home = self._stage(x)
        out = torch.empty((d,) + tuple(y.shape), dtype=y.dtype,
                          device=y.device)
        dist.all_gather_into_tensor(out.view(-1), y.reshape(-1), group=g)
        out = out if home is None else out.to(home)
        self.seconds += time.perf_counter() - t0
        return out


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame_site(f) -> str:
    return "%s:%d" % (os.path.relpath(f.f_code.co_filename, _PKG_DIR)
                      .replace(os.sep, "/"), f.f_lineno)


def log_entry(op: str, axis: Optional[str], x: torch.Tensor) -> dict:
    """One collective of ``Mesh.log``: its op, axis (``*`` for the whole
    mesh), operand dtype and payload bytes, and the site that issued it:
    the first two frames outside this file and the learners' one-line
    forwarder ``_coll`` (``path:line<-path:line``, paths in the package),
    so a helper issued from two places counts as two sites."""
    f = sys._getframe(1)
    while f is not None and (f.f_code.co_filename == __file__
                             or f.f_code.co_name == "_coll"):
        f = f.f_back
    site = []
    while f is not None and len(site) < 2:
        site.append(_frame_site(f))
        f = f.f_back
    return {"op": op, "axis": axis or "*",
            "dtype": str(x.dtype).replace("torch.", ""),
            "bytes": int(x.numel()) * int(x.element_size()),
            "site": "<-".join(site)}


# -- mesh construction --------------------------------------------------------

def make_mesh(num_devices: Optional[int] = None, axis_name: str = AXIS_DATA,
              shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """Mesh over the process group's ranks: ``make_mesh()`` -> every rank on
    axis ``data``; ``make_mesh(shape=(2, 2))`` -> a data x feature grid.
    ``num_devices``, where given, must be the group's size."""
    if shape is None:
        n = world_size() if num_devices is None else int(num_devices)
        return Mesh((n,), (axis_name,))
    if axis_names is None:
        axis_names = (AXIS_DATA, AXIS_FEATURE)[:len(shape)]
    return Mesh(shape, axis_names)


def parse_mesh_shape(spec: str) -> Optional[Tuple[int, ...]]:
    """``"2x4"`` -> ``(2, 4)``; ``"8"`` -> ``(8,)``; ``""``/``"auto"`` ->
    None (let the mode pick).  The ``parallel_mesh`` grammar; for
    ``data_feature`` the order is data x feature."""
    s = str(spec or "").strip().lower()
    if s in ("", "auto"):
        return None
    parts = [p for p in re.split(r"[x*,]", s) if p]
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(f"parallel_mesh={spec!r} is not of the form "
                         f"'D' or 'DxF'")
    if not dims or any(d <= 0 for d in dims) or len(dims) > 2:
        raise ValueError(f"parallel_mesh={spec!r} must be 1 or 2 positive "
                         f"dims")
    return dims


def default_mesh_shape_2d(n_devices: int) -> Tuple[int, int]:
    """Auto (data, feature) factorization: the feature axis gets the
    smaller balanced factor."""
    n = max(int(n_devices), 1)
    df = 1
    for f in range(int(np.sqrt(n)), 0, -1):
        if n % f == 0:
            df = f
            break
    return n // df, df


def mesh_for_config(cfg) -> Mesh:
    """The mesh a Config asks for: ``parallel_mesh`` when set, else every
    rank; 2-D for ``tree_learner=data_feature``, 1-D otherwise."""
    mode = getattr(cfg, "tree_learner", "serial")
    shape = parse_mesh_shape(getattr(cfg, "parallel_mesh", ""))
    n = world_size()
    if mode == "data_feature":
        if shape is None:
            shape = default_mesh_shape_2d(n)
        elif len(shape) == 1:
            shape = default_mesh_shape_2d(shape[0])
        return make_mesh(shape=shape, axis_names=(AXIS_DATA, AXIS_FEATURE))
    if shape is not None:
        return make_mesh(int(np.prod(shape)))
    return make_mesh()


# -- axis resolution ----------------------------------------------------------

def row_axis(mesh: Mesh) -> str:
    """The row-shard axis: ``data`` when present, else the first axis."""
    return AXIS_DATA if AXIS_DATA in mesh.axis_names else mesh.axis_names[0]


def feature_axis(mesh: Mesh) -> str:
    return AXIS_FEATURE if AXIS_FEATURE in mesh.axis_names \
        else mesh.axis_names[0]


# -- regex -> placement rules -------------------------------------------------

Spec = Tuple[Optional[str], ...]


class PlacementRules:
    """Ordered (regex, spec) table bound to a mesh; first match wins, no
    match replicates.  A spec names, per dimension, the mesh axis that
    splits it (None: whole), as a ``PartitionSpec`` does."""

    def __init__(self, mesh: Mesh, rules: Sequence[Tuple[str, Spec]]) -> None:
        self.mesh = mesh
        self.rules: List[Tuple[re.Pattern, Spec]] = [
            (re.compile(pat), tuple(spec)) for pat, spec in rules]

    def spec_for(self, name: str) -> Spec:
        for pat, spec in self.rules:
            if pat.search(name):
                return spec
        return ()

    def _block(self, axis: str, n: int):
        """(start, stop) of this rank's block of a dimension of size ``n``
        split over ``axis``: blocks of ceil(n / ranks), the last shorter
        where ``n`` does not divide."""
        k = -(-n // self.mesh.axis_size(axis))
        start = min(self.mesh.axis_index(axis) * k, n)
        return start, min(start + k, n)

    def place(self, name: str, arr):
        """This rank's block of the global array ``arr`` under ``name``'s
        rule (a view of a tensor)."""
        for dim, axis in enumerate(self.spec_for(name)):
            if axis is None or self.mesh.axis_size(axis) == 1:
                continue
            lo, hi = self._block(axis, arr.shape[dim])
            arr = arr.narrow(dim, lo, hi - lo) if torch.is_tensor(arr) \
                else np.take(arr, np.arange(lo, hi), axis=dim)
        return arr

    def gather(self, name: str, local: torch.Tensor, n: int) -> torch.Tensor:
        """The whole array from every rank's block under ``name``'s rule
        (the inverse of ``place``; ``n`` the size of the split dimension,
        one split dimension at most)."""
        for dim, axis in enumerate(self.spec_for(name)):
            if axis is None or self.mesh.axis_size(axis) == 1:
                continue
            d = self.mesh.axis_size(axis)
            k = -(-n // d)
            if local.shape[dim] < k:
                pad = list(local.shape)
                pad[dim] = k - local.shape[dim]
                local = torch.cat([local, local.new_zeros(pad)], dim)
            parts = self.mesh.all_gather(local.contiguous(), axis)
            return torch.cat(list(parts), dim).narrow(dim, 0, n)
        return local


#: row-aligned 1-D vector names used across the boosting loop / objectives
_ROW_VECTORS = (r"(^|/)(valid_rows|bag_mask|grad|hess|bag|rows|label|"
                r"weights|trans_label|label_sign|label_w|label_weight)$")
#: (K, N) row-aligned matrices (score table, one-hot labels)
_ROW_MATRICES = r"(^|/)(score|label_onehot)$"


def rules_for_mode(mode: str, mesh: Mesh) -> PlacementRules:
    """The per-mode placement tables of the JAX package: rows split over
    the data axis for ``data`` / ``voting``, everything whole for
    ``feature``, an (F, N) tile per rank for ``data_feature``."""
    d, f = row_axis(mesh), feature_axis(mesh)
    if mode in ("data", "voting"):
        table = [(r"(^|/)bins$", (None, d)),
                 (_ROW_MATRICES, (None, d)),
                 (_ROW_VECTORS, (d,))]
    elif mode == "feature":
        table = [(r"(^|/)bins$", (None, None))]
    elif mode == "data_feature":
        table = [(r"(^|/)bins$", (f, d)),
                 (_ROW_MATRICES, (None, d)),
                 (_ROW_VECTORS, (d,))]
    else:
        raise ValueError(f"unknown parallel mode {mode!r}")
    return PlacementRules(mesh, table)
