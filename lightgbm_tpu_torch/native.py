"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``, then
loaded with ``ctypes``.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing is built when a module is imported: the first kernel
launch builds its library, and ``build_all`` builds several in parallel (one
``nvcc`` process per source).  Every wrapper launches through ``launch``;
inside ``staging()`` each launch is also kept as a ``Replay``, which calls
the C entry point again on the same buffers with no torch work around it
(``chip_smoke.py`` times a kernel alone that way).

Every wrapper counts its launches through ``count``.  A CUDA graph captured
with ``capture`` runs nothing: the launches its capture makes go to the
capture's own tally, which ``credit`` adds to the wrappers' counters once
per replay.  ``capture`` is safe beside other threads' device work on the
same card (a server's replicas replaying and capturing while a refit
trains): it records on the card's capture stream, which no serving model
ever holds (``capture_stream``), takes no device-wide synchronisation or
cache release (``torch.cuda.graph``'s entry takes both, and shares one
capture stream between threads), and captures one graph at a time in the
process.

Host libraries (``csrc/<name>.cpp``: the text parser) are C++ for the CPU,
not kernels: ``load_host`` compiles one with ``g++`` (or ``$CXX``) into
``_build/lib<name>-<hash>.so`` at first use, on any machine with a C++
compiler and without ``nvcc``, and raises if it cannot.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: per-source additions: the split scans' gain arithmetic must round after
#: every operation, as the plain torch version does (no fused multiply-add)
EXTRA_FLAGS: Dict[str, List[str]] = {"split_scan": ["-fmad=false"],
                                     "fused_scan": ["-fmad=false"],
                                     "split_cat": ["-fmad=false"]}
#: every kernel source of the port
KERNELS = ("hist_packed", "hist_segments", "partition", "split_scan",
           "hist_multislot", "fused_scan", "hist_full", "replay",
           "split_cat", "bin_predict")
#: the kernel each wrapper launches, by source, as a profiler names it
KERNEL_SYMBOLS = {"hist_packed": "hist_packed_chunks",
                  "hist_segments": "hist_segments_tiles",
                  "partition": "partition_rows", "split_scan": "split_scan",
                  "hist_multislot": "hist_multislot_chunks",
                  "fused_scan": "fused_child_scan", "replay": "replay_pass",
                  "split_cat": "split_cat", "bin_predict": "bin_predict_rows"}
#: the host libraries' compiler flags (``load_host``)
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

#: seconds each library took to build in this process (0.0 = reused)
BUILD_SECONDS: Dict[str, float] = {}
#: nvcc's register / shared-memory report per library built in this process
PTXAS_REPORT: Dict[str, str] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}
#: the launches recorded inside ``staging()`` (None outside it)
_STAGED: Optional[List["Replay"]] = None


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin``, else from
    ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = Path(root) / "bin" / "nvcc"
        if root and cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        src += hdr.read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start_build(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *_flags(name), "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish_build(name: str, started) -> None:
    if started is None:
        BUILD_SECONDS.setdefault(name, 0.0)
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builders agree
    BUILD_SECONDS[name] = time.perf_counter() - t0
    PTXAS_REPORT[name] = log


def build_all(names: Iterable[str]) -> None:
    """Build every named library that is not built yet, all ``nvcc``
    processes started together."""
    names = list(names)
    started: List = []
    try:
        for n in names:
            started.append(_start_build(n))
    finally:
        for n, s in zip(names, started):
            _finish_build(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


class Replay:
    """One recorded launch: the C entry point and its raw arguments, with
    the tensors they point into held alive.  Calling it launches the kernel
    again on the same buffers (outputs are overwritten; a kernel that
    updates a buffer in place updates it again) and counts nowhere."""

    def __init__(self, what: str, fn, raw: tuple, tensors: tuple):
        self.what, self.fn, self.raw, self._tensors = what, fn, raw, tensors

    def __call__(self) -> None:
        _check(self.what, self.fn(*self.raw))


def _check(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def launch(what: str, fn, *args) -> None:
    """Call the C entry point ``fn`` with ``args``, tensors passed as their
    data pointers, and raise if it returns a CUDA error (a refused launch
    never runs and no later synchronisation reports it)."""
    raw = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args)
    _check(what, fn(*raw))
    if _STAGED is not None:
        _STAGED.append(Replay(what, fn, raw, tuple(
            a for a in args if isinstance(a, torch.Tensor))))


#: guards the wrappers' launch counters: a server's batch thread credits its
#: graphs' replays while other threads launch
_COUNT_LOCK = threading.Lock()
#: ``.tally`` is the launch tally of the capture this thread is making
_CAPTURING = threading.local()
#: one capture at a time in the process: two captures on one card would
#: otherwise interleave their private memory pools' bookkeeping
_CAPTURE_LOCK = threading.RLock()
#: the capture stream of each card, one for the process (captures are
#: serialised by ``_CAPTURE_LOCK``), drawn from PyTorch's high-priority
#: stream pool.  The serving models' streams come from the default-priority
#: pool, which hands out its 32 streams per card round-robin: a capture
#: stream taken from that pool would in time be the very stream a live
#: replica replays and synchronises on, and the replica's work would be
#: recorded into the capture or its synchronisation would fail.
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def count(fn, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` launches of the wrapper ``fn`` to ``fn.<attr>``, or to the
    tally of the graph this thread is capturing (``capture``)."""
    if not n:
        return
    tally = getattr(_CAPTURING, "tally", None)
    if tally is not None:
        tally[fn, attr] = tally.get((fn, attr), 0) + n
        return
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The capture stream of the card ``device`` (``_CAPTURE_STREAMS``);
    no stream of the default-priority pool is ever it."""
    with _CAPTURE_LOCK:
        s = _CAPTURE_STREAMS.get(device.index)
        if s is None:
            s = _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(
                device, priority=-1)
    return s


def capture(graph: "torch.cuda.CUDAGraph", fn, pool, mode: str,
            device: Optional[torch.device] = None):
    """Capture ``fn()`` into ``graph`` in the memory pool ``pool`` with
    ``capture_error_mode=mode`` on ``device`` (default: the current card);
    returns ``fn``'s result and the wrapper launches one replay makes,
    ``{(wrapper, counter): n}``.  The capture stream waits for the calling
    stream's work first, and the calling stream for the capture's after,
    so no device-wide synchronisation is needed.  A pass that cannot be
    captured raises."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    prev = getattr(_CAPTURING, "tally", None)
    _CAPTURING.tally = tally = {}
    try:
        with _CAPTURE_LOCK, torch.cuda.device(dev):
            caller = torch.cuda.current_stream(dev)
            side = capture_stream(dev)
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool, capture_error_mode=mode)
                try:
                    out = fn()
                finally:
                    graph.capture_end()
            caller.wait_stream(side)
    finally:
        _CAPTURING.tally = prev
    return out, tally


def credit(tally: Dict) -> None:
    """Add one replay's launches (a ``capture`` tally) to the wrappers'
    counters."""
    with _COUNT_LOCK:
        for (fn, attr), n in tally.items():
            setattr(fn, attr, getattr(fn, attr) + n)


@contextmanager
def staging():
    """Record every launch made inside the block; yields the list."""
    global _STAGED
    prev, _STAGED = _STAGED, []
    try:
        yield _STAGED
    finally:
        _STAGED = prev


def find_cxx() -> str:
    """``$CXX``, else ``g++``, else ``c++`` from PATH."""
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler found ($CXX, g++, c++): the "
                           "port's host library cannot be built")
    return found


def host_library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(HOST_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for ``csrc/<name>.cpp``, built with the C++
    compiler on first use; raises ``RuntimeError`` with the compiler's
    output if the build fails."""
    key = f"host:{name}"
    lib = _LOADED.get(key)
    if lib is None:
        out = host_library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                                       dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_cxx(), *HOST_FLAGS, "-o", tmp,
                   str(CSRC_DIR / f"{name}.cpp")]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                Path(tmp).unlink(missing_ok=True)
                raise RuntimeError(f"cannot run the C++ compiler to build "
                                   f"csrc/{name}.cpp: {e}") from None
            if res.returncode != 0:
                Path(tmp).unlink(missing_ok=True)
                raise RuntimeError(
                    f"the C++ compiler failed to build csrc/{name}.cpp "
                    f"(exit {res.returncode}):\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _LOADED[key] = lib
    return lib
