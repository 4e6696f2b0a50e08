"""Binned training dataset: host binning, device-resident bin codes.

Port of ``lightgbm_tpu/dataset.py``.  Binning is the same host numpy code
(``binning.py``, ``efb.py``), so bin mappers and the binned matrix are
bit-identical to the JAX package's.  The layout is kept:

  * ``bins`` is ONE dense ``(features_padded, rows_padded)`` uint8/uint16
    numpy array; features pad to ``FEATURE_TILE`` (8) so the packed-word
    histogram sees whole 4-feature words, rows pad to ``tpu_row_block``.
  * ``device_bins(device)`` uploads it once per ``torch.device`` as a uint8
    tensor, uint16 past 256 bins (the JAX package's HBM-resident
    ``device_bins()``).  The card has few kernels for uint16, so consumers
    widen uint16 codes through ``ops/histogram.py:read_codes``.

Inputs: numpy, scipy sparse, pandas DataFrames (``category`` columns coded
through category lists recorded on the training set and reapplied to its
validation sets and, through the model text, at predict time), text files
(CSV, TSV, LibSVM with ``.weight`` / ``.query`` sidecars:
``io/parser.py``), the binary cache ``save_binary`` writes (the JAX
package's ``.npz`` layout, so either package loads the other's), and with
``two_round=true`` a text file streamed in two passes
(``_ConstructedDataset.from_stream``) without its float64
matrix; a stream keeps the rows its rank owns (``rank`` /
``num_machines`` / ``pre_partition``), and under ``elastic=true`` in a pod
it is re-dealt over the current membership (``elastic/redeal.py``).  Query
groups (``group=``, per-query sizes) are stored as
boundaries.  Categorical features (``categorical_feature``: a list of
indices or names, ``"0,2"`` or ``"name:c1,c2"``) get the count-sorted
categorical bin mapper and stay out of EFB bundles.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper, kZeroThreshold
from .config import Config

_ArrayLike = Union[np.ndarray, Sequence[float], None]


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def upload(arr: np.ndarray, device):
    """numpy -> tensor on ``device``.  To a CUDA device the copy goes through
    pinned memory and does not block the host: a pageable host-to-device
    copy would synchronise the stream."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class Metadata:
    """Labels, weights, query boundaries, init scores (as the JAX package)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label = np.zeros(num_data, dtype=np.float32)
        self.weights: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label: _ArrayLike) -> None:
        arr = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(arr) != self.num_data:
            raise ValueError(f"Length of label ({len(arr)}) != num_data ({self.num_data})")
        self.label = arr

    def set_weights(self, weights: _ArrayLike) -> None:
        if weights is None:
            self.weights = None
            return
        arr = np.asarray(weights, dtype=np.float32).reshape(-1)
        if len(arr) != self.num_data:
            raise ValueError(f"Length of weights ({len(arr)}) != num_data ({self.num_data})")
        self.weights = arr

    def set_group(self, group: _ArrayLike) -> None:
        """Per-query sizes (like the reference's query file), stored as
        boundaries (`metadata.cpp` ``SetQuery``)."""
        if group is None:
            self.query_boundaries = None
            return
        arr = np.asarray(group, dtype=np.int64).reshape(-1)
        bounds = np.concatenate([[0], np.cumsum(arr)])
        if bounds[-1] != self.num_data:
            raise ValueError(f"Sum of group sizes ({bounds[-1]}) != num_data "
                             f"({self.num_data})")
        self.query_boundaries = bounds.astype(np.int32)

    def set_init_score(self, init_score: _ArrayLike) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score, dtype=np.float64).reshape(-1)

    def subset(self, idx: np.ndarray) -> "Metadata":
        """Row subset (`metadata.cpp` Init(metadata, used_indices)); query
        boundaries are rebuilt only when the subset keeps whole queries in
        order."""
        out = Metadata(len(idx))
        out.label = self.label[idx]
        if self.weights is not None:
            out.weights = self.weights[idx]
        if self.init_score is not None:
            k = len(self.init_score) // max(self.num_data, 1)
            out.init_score = self.init_score.reshape(
                k, self.num_data)[:, idx].reshape(-1)
        if self.query_boundaries is not None:
            qid = np.searchsorted(self.query_boundaries, idx, "right") - 1
            if (np.diff(qid) >= 0).all():
                _, sizes = np.unique(qid, return_counts=True)
                out.set_group(sizes)
            else:
                raise ValueError("subset of a ranking dataset must keep "
                                 "query groups contiguous")
        return out


def recode_pandas(df, cat_cols, stored) -> np.ndarray:
    """DataFrame -> float64 matrix with the ``category`` columns
    ``cat_cols`` coded through the ``stored`` category lists, paired by
    position; a value outside its stored list becomes NaN (JAX
    ``dataset.py:recode_pandas``)."""
    cols = []
    ci = 0
    for j in range(df.shape[1]):
        s = df.iloc[:, j]
        if j in cat_cols:
            s = s.cat.set_categories(stored[ci])
            ci += 1
            codes = s.cat.codes.to_numpy().astype(np.float64)
            codes[codes < 0] = np.nan
            cols.append(codes)
        else:
            cols.append(np.asarray(s, dtype=np.float64))
    return np.column_stack(cols)


class Dataset:
    """User-facing dataset: lazy construction, reference-linked validation
    sets (the JAX package's ``Dataset`` for in-memory arrays)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None, feature_name="auto",
                 categorical_feature="auto", params: Optional[Dict] = None,
                 free_raw_data: bool = False):
        self.params = dict(params or {})
        self._raw_data = data
        self._label = label
        self._weight = weight
        self._group = group
        self._init_score = init_score
        self.reference = reference
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.free_raw_data = free_raw_data
        self._constructed: Optional[_ConstructedDataset] = None
        self.used_indices: Optional[np.ndarray] = None
        # the category lists of a DataFrame's ``category`` columns, recorded
        # by ``_data_from_pandas`` (`basic.py:262-304`) and stored in the
        # model, so validation and predict frames use the same codes
        self.pandas_categorical: Optional[List[list]] = None
        self._pandas_cat_cols: List[int] = []

    def construct(self) -> "Dataset":
        if self._constructed is None:
            cfg = Config.from_params(self.params)
            raw = self._raw_data
            if cfg.elastic and not (
                    isinstance(raw, str) and cfg.two_round
                    and self.reference is None
                    and not _ConstructedDataset.is_binary_file(raw)):
                import warnings
                warnings.warn(
                    "elastic=true but this Dataset is not a two_round "
                    "file source: in-memory (and binary/reference) "
                    "Datasets CANNOT re-deal rows after a membership "
                    "shrink — whatever rows this process holds is all "
                    "it will ever have. Only from_stream sources "
                    "(two_round=true with a file path) survive elastic "
                    "recovery; this run will NOT be elastic-safe.",
                    RuntimeWarning, stacklevel=2)
            if isinstance(raw, str) and _ConstructedDataset.is_binary_file(
                    raw):
                self._constructed = _ConstructedDataset.load_binary(raw, cfg)
            elif isinstance(raw, str) and cfg.two_round \
                    and self.reference is None:
                from .io.parser import scan_data_file
                from .parallel import multihost
                info = scan_data_file(raw, self.params)
                shape = type("_Shape", (), {
                    "shape": (info.num_rows, info.num_features)})
                kw = dict(categorical=self._resolve_categorical(shape),
                          feature_names=self._resolve_feature_names(shape),
                          info=info)
                if cfg.elastic and multihost.is_initialized():
                    # the elastic re-deal: rank and machines come from the
                    # current membership epoch's world, not the config
                    from .elastic.redeal import construct_elastic
                    self._constructed = construct_elastic(
                        raw, self.params, cfg, **kw)
                else:
                    self._constructed = _ConstructedDataset.from_stream(
                        raw, self.params, cfg, **kw)
            else:
                if self.reference is not None:
                    # first: a DataFrame is coded with its category lists
                    self.reference.construct()
                data = self._load_raw(raw)
                if self.reference is not None:
                    self._constructed = _ConstructedDataset.from_reference(
                        data, self.reference._constructed, cfg)
                else:
                    self._constructed = _ConstructedDataset.from_matrix(
                        data, cfg,
                        categorical=self._resolve_categorical(data),
                        feature_names=self._resolve_feature_names(data))
                if self.free_raw_data:
                    self._raw_data = None
            # the caller's fields override what a file or a cache carries
            md = self._constructed.metadata
            if self._label is not None:
                md.set_label(self._label)
            if self._weight is not None:
                md.set_weights(self._weight)
            if self._group is not None:
                md.set_group(self._group)
            if self._init_score is not None:
                md.set_init_score(self._init_score)
        return self

    def _load_raw(self, data) -> np.ndarray:
        if isinstance(data, str):
            from .io.parser import load_data_file
            mat, label, weight, group = load_data_file(data, self.params)
            if self._label is None and label is not None:
                self._label = label
            if self._weight is None and weight is not None:
                self._weight = weight
            if self._group is None and group is not None:
                self._group = group
            return mat
        if hasattr(data, "toarray"):  # scipy sparse
            return np.asarray(data.toarray(), dtype=np.float64)
        if hasattr(data, "dtypes") and hasattr(data, "columns") \
                and not isinstance(data, np.ndarray):  # pandas DataFrame
            return self._data_from_pandas(data)
        if hasattr(data, "values") and not isinstance(data, np.ndarray):
            return np.asarray(data.values, dtype=np.float64)
        return np.asarray(data, dtype=np.float64)

    def _data_from_pandas(self, df) -> np.ndarray:
        """DataFrame -> float64 matrix (`basic.py:262-304`
        ``_data_from_pandas``, JAX ``dataset.py:278-304``): ``category``
        columns become their codes (unseen -> NaN) under the category lists
        recorded here on a training set or taken from the reference on a
        validation set."""
        cat_cols = [j for j in range(df.shape[1])
                    if str(df.dtypes.iloc[j]) == "category"]
        if not cat_cols:
            return np.asarray(df.values, dtype=np.float64)
        stored = None
        if self.reference is not None:
            stored = self.reference.pandas_categorical
        if stored is None:
            stored = [df.iloc[:, j].cat.categories.tolist()
                      for j in cat_cols]
        if len(stored) != len(cat_cols):
            raise ValueError(
                "train and valid dataset categorical_feature do not match "
                f"({len(stored)} recorded category columns vs "
                f"{len(cat_cols)} in this DataFrame)")
        self.pandas_categorical = stored
        self._pandas_cat_cols = list(cat_cols)
        return recode_pandas(df, cat_cols, stored)

    def _resolve_feature_names(self, data) -> List[str]:
        if isinstance(self.feature_name, (list, tuple)):
            return list(self.feature_name)
        raw = self._raw_data
        if hasattr(raw, "columns"):
            return [str(c) for c in raw.columns]
        return [f"Column_{i}" for i in range(data.shape[1])]

    def _resolve_categorical(self, data) -> List[int]:
        """The categorical columns, sorted (JAX ``dataset.py:314-337``):
        ``categorical_feature`` as indices or names, else a DataFrame's
        ``category`` columns, else the config's ``categorical_feature``
        (``"0,1,2"`` or ``"name:c1,c2"``)."""
        cf = self.categorical_feature
        if cf == "auto" or cf is None or cf == "":
            if self._pandas_cat_cols:
                return sorted(self._pandas_cat_cols)
            cf = Config.from_params(self.params).categorical_feature
            if not cf:
                return []
        if isinstance(cf, str):
            if cf.startswith("name:"):
                cf = [c.strip() for c in cf[5:].split(",") if c.strip()]
            else:
                cf = [int(c) for c in cf.split(",") if c.strip()]
        names = self._resolve_feature_names(data)
        return sorted(names.index(c) if isinstance(c, str) else int(c)
                      for c in cf)

    def set_label(self, label):
        self._label = label
        if self._constructed:
            self._constructed.metadata.set_label(label)
        return self

    def set_weight(self, weight):
        self._weight = weight
        if self._constructed:
            self._constructed.metadata.set_weights(weight)
        return self

    def set_group(self, group):
        self._group = group
        if self._constructed:
            self._constructed.metadata.set_group(group)
        return self

    def set_init_score(self, init_score):
        self._init_score = init_score
        if self._constructed:
            self._constructed.metadata.set_init_score(init_score)
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        """The column names (a list), used when the dataset is built."""
        self.feature_name = feature_name
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """The categorical columns (indices, names, ``"0,2"`` or
        ``"name:c1,c2"``), used when the dataset is built."""
        self.categorical_feature = categorical_feature
        return self

    def get_label(self):
        if self._constructed is not None:
            return self._constructed.metadata.label
        return self._label

    def get_weight(self):
        if self._constructed is not None:
            return self._constructed.metadata.weights
        return self._weight

    def get_group(self):
        """Per-query sizes, or None."""
        if self._constructed is not None \
                and self._constructed.metadata.query_boundaries is not None:
            return np.diff(self._constructed.metadata.query_boundaries)
        return self._group

    def get_init_score(self):
        if self._constructed is not None:
            return self._constructed.metadata.init_score
        return self._init_score

    def num_data(self) -> int:
        return self.construct()._constructed.num_data

    def num_feature(self) -> int:
        return self.construct()._constructed.num_total_features

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    @property
    def constructed(self) -> "_ConstructedDataset":
        return self.construct()._constructed

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned dataset as a binary cache (`basic.py:1078`);
        ``Dataset(filename)`` loads it without binning again."""
        self.construct()._constructed.save_binary(filename)
        return self

    @classmethod
    def _from_constructed(cls, constructed: "_ConstructedDataset",
                          params: Optional[Dict] = None) -> "Dataset":
        ds = cls(None, params=params)
        ds._constructed = constructed
        return ds

    def subset(self, used_indices, params: Optional[Dict] = None
               ) -> "Dataset":
        """A row subset sharing this dataset's bin mappers, no re-binning
        (`basic.py:1053`, JAX ``dataset.py:419``); the subset has no EFB
        bundle."""
        con = self.construct()._constructed
        idx = np.asarray(used_indices, dtype=np.int64)
        sub = _ConstructedDataset()
        sub.num_data = len(idx)
        sub.num_total_features = con.num_total_features
        sub.feature_names = con.feature_names
        sub.config = con.config
        sub.bin_mappers = con.bin_mappers
        sub.used_feature_map = con.used_feature_map
        sub.num_data_padded = _round_up(max(len(idx), 1), max(
            int(con.config.tpu_row_block), 128))
        sub.max_num_bin = con.max_num_bin
        sub.bins = np.zeros((con.bins.shape[0], sub.num_data_padded),
                            dtype=con.bins.dtype)
        sub.bins[:, :len(idx)] = con.bins[:, :con.num_data][:, idx]
        sub.metadata = con.metadata.subset(idx)
        out = Dataset._from_constructed(sub, params or self.params)
        out.used_indices = idx
        out.reference = self
        return out

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append ``other``'s features to this dataset in place
        (`basic.py:1121`, JAX ``dataset.py:442``): its used features after
        this one's, its raw columns after this one's.  The bundles are found
        again over the joined codes."""
        a = self.construct()._constructed
        b = other.construct()._constructed
        if a.num_data != b.num_data:
            raise ValueError("add_features_from: datasets have different "
                             f"row counts ({a.num_data} vs {b.num_data})")
        fa = a.num_total_features
        n_pad = max(a.num_data_padded, b.num_data_padded)
        fu = a.num_used_features + b.num_used_features
        fu_pad = _round_up(max(fu, 1), _ConstructedDataset.FEATURE_TILE)
        dtype = np.uint8 if max(a.max_num_bin, b.max_num_bin) <= 256 \
            else np.uint16
        bins = np.zeros((fu_pad, n_pad), dtype=dtype)
        bins[:a.num_used_features, :a.num_data] = \
            a.bins[:a.num_used_features, :a.num_data]
        bins[a.num_used_features:fu, :b.num_data] = \
            b.bins[:b.num_used_features, :b.num_data]
        a.bins = bins
        a.num_data_padded = n_pad
        a.bin_mappers = list(a.bin_mappers) + list(b.bin_mappers)
        a.used_feature_map = np.concatenate(
            [a.used_feature_map, b.used_feature_map + fa]).astype(np.int32)
        a.num_total_features = fa + b.num_total_features
        a.feature_names = list(a.feature_names) + list(b.feature_names)
        a.max_num_bin = max(a.max_num_bin, b.max_num_bin)
        a._device_bins = {}
        a._feature_meta = None
        a._binner_arrays = None
        a.bundle = None
        a._maybe_bundle(a.config)
        return self


class _ConstructedDataset:
    """The materialized binned dataset (see the module docstring)."""

    FEATURE_TILE = 8  # feature-axis padding multiple (whole packed words)

    def __init__(self) -> None:
        self.bins: np.ndarray = None
        self.bin_mappers: List[BinMapper] = []
        self.used_feature_map: np.ndarray = None
        self.num_data: int = 0
        self.num_data_padded: int = 0
        self.num_total_features: int = 0
        self.feature_names: List[str] = []
        self.metadata: Metadata = None
        self.max_num_bin: int = 1
        self.config: Config = None
        self.bundle = None
        self._device_bins: Dict[str, object] = {}
        self._feature_meta = None

    @classmethod
    def from_matrix(cls, mat: np.ndarray, cfg: Config,
                    categorical: Sequence[int] = (),
                    feature_names: Optional[List[str]] = None
                    ) -> "_ConstructedDataset":
        self = cls()
        mat = np.ascontiguousarray(mat, dtype=np.float64)
        n, f = mat.shape
        self.num_data = n
        self.num_total_features = f
        self.feature_names = feature_names or [f"Column_{i}" for i in range(f)]
        self.config = cfg
        self.metadata = Metadata(n)
        sample_idx = cls._sample_indices(n, cfg)
        sample = mat if sample_idx is None else mat[sample_idx]
        self._find_mappers(sample, cfg, categorical)
        self._bin_all(mat, cfg)
        return self

    @staticmethod
    def _sample_indices(n: int, cfg: Config) -> Optional[np.ndarray]:
        """Rows sampled for bin finding (None = all rows), drawn exactly as
        the JAX package draws them."""
        if n > cfg.bin_construct_sample_cnt:
            rng = np.random.RandomState(cfg.data_random_seed)
            return np.sort(rng.choice(n, cfg.bin_construct_sample_cnt,
                                      replace=False))
        return None

    def _find_mappers(self, sample: np.ndarray, cfg: Config,
                      categorical: Sequence[int] = ()) -> None:
        """FindBin over the sample -> ``bin_mappers`` + ``used_feature_map``
        (trivial features dropped); the ``categorical`` columns get the
        categorical mapper."""
        categorical = set(categorical)
        self.bin_mappers = []
        keep: List[int] = []
        for j in range(self.num_total_features):
            m = BinMapper()
            col = sample[:, j]
            # only non-zero/NaN values are sampled; FindBin infers the zero
            # count from total_sample_cnt (bin boundaries depend on it)
            col = col[(np.abs(col) > kZeroThreshold) | np.isnan(col)]
            m.find_bin(col, total_sample_cnt=len(sample),
                       max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
                       min_split_data=cfg.min_data_in_leaf,
                       bin_type=BIN_CATEGORICAL if j in categorical
                       else BIN_NUMERICAL,
                       use_missing=cfg.use_missing,
                       zero_as_missing=cfg.zero_as_missing)
            if not m.is_trivial:
                keep.append(j)
                self.bin_mappers.append(m)
        self.used_feature_map = np.asarray(keep, dtype=np.int32)

    @classmethod
    def from_stream(cls, path: str, params: Optional[Dict], cfg: Config,
                    categorical: Sequence[int] = (),
                    feature_names: Optional[List[str]] = None,
                    rank: int = 0, num_machines: int = 1,
                    pre_partition: bool = False, info=None,
                    net=None) -> "_ConstructedDataset":
        """The reference's ``two_round`` loading (`dataset_loader.cpp:133`,
        JAX ``dataset.py:564-704``): pass 0 counts the rows
        (``scan_data_file``); pass 1 streams chunks keeping only the rows
        ``_sample_indices`` draws, then FindBin on them (mappers equal to
        ``from_matrix``'s); pass 2 streams again, keeps the rows this rank
        owns (``global_row % num_machines == rank``, whole query groups with
        a ``.query`` sidecar, every row with ``pre_partition`` or one
        machine) and bins them into ``bins``.  Host memory holds a chunk,
        the sample and the owned codes, never the float64 matrix.

        With a ``net`` (``io/distributed.py``'s seam; ``rank`` and
        ``num_machines`` are then the net's) FindBin is distributed: each
        rank bins its contiguous feature range of the sample
        (``_feature_ranges``) and the serialized mappers are allgathered,
        so every rank holds the single-host table.  Across machines EFB is
        off (``_maybe_bundle``'s reference-linked rule)."""
        from .io.parser import _load_sidecar, iter_data_chunks, \
            scan_data_file

        params = dict(params or {})
        if net is not None:
            rank, num_machines = int(net.rank), int(net.num_machines)
        if info is None:
            info = scan_data_file(path, params)
        n, f = info.num_rows, info.num_features
        self = cls()
        self.num_total_features = f
        self.feature_names = list(feature_names) if feature_names \
            else [f"Column_{i}" for i in range(f)]
        self.config = cfg
        chunk_rows = max(int(cfg.stream_chunk_rows), 1)

        sample_idx = self._sample_indices(n, cfg)
        parts: List[np.ndarray] = []
        for start, mat, _ in iter_data_chunks(path, params, chunk_rows,
                                              info=info):
            if sample_idx is None:
                parts.append(mat)
            else:
                lo = np.searchsorted(sample_idx, start)
                hi = np.searchsorted(sample_idx, start + len(mat))
                if hi > lo:
                    parts.append(mat[sample_idx[lo:hi] - start])
        sample = np.concatenate(parts, axis=0) if parts \
            else np.zeros((0, f), dtype=np.float64)
        parts = []
        if net is not None and num_machines > 1:
            self._find_mappers_distributed(sample, cfg, categorical, net)
        else:
            self._find_mappers(sample, cfg, categorical)

        weight = _load_sidecar(path + ".weight")
        group = _load_sidecar(path + ".query")
        if group is not None and int(np.sum(group)) != n:
            raise ValueError(f"query file rows ({int(np.sum(group))}) "
                             f"!= data rows ({n})")
        qgroup = None
        if num_machines > 1 and not pre_partition:
            if group is not None:
                from .io.distributed import partition_queries
                owned, qgroup = partition_queries(group, rank, num_machines)
            else:
                owned = np.arange(rank, n, num_machines, dtype=np.int64)
        else:
            owned = np.arange(n, dtype=np.int64)
        n_local = len(owned)
        self.num_data = n_local
        block = max(int(cfg.tpu_row_block), 128)
        self.num_data_padded = _round_up(max(n_local, 1), block)
        self.max_num_bin = max((m.num_bin for m in self.bin_mappers),
                               default=1)
        dtype = np.uint8 if self.max_num_bin <= 256 else np.uint16
        fu_pad = _round_up(max(len(self.bin_mappers), 1), self.FEATURE_TILE)
        self.bins = np.zeros((fu_pad, self.num_data_padded), dtype=dtype)
        labels = np.zeros(n_local, dtype=np.float64)
        dst = 0
        for start, mat, lab in iter_data_chunks(path, params, chunk_rows,
                                                info=info):
            lo = np.searchsorted(owned, start)
            hi = np.searchsorted(owned, start + len(mat))
            if hi <= lo:
                continue
            rows = owned[lo:hi] - start
            sub = mat[rows]
            for k, m in enumerate(self.bin_mappers):
                j = int(self.used_feature_map[k])
                self.bins[k, dst:dst + len(rows)] = \
                    m.values_to_bins(sub[:, j]).astype(dtype)
            labels[dst:dst + len(rows)] = lab[rows]
            dst += len(rows)
        if dst != n_local:
            raise ValueError(f"stream produced {dst} owned rows, expected "
                             f"{n_local}: the file changed during the load?")
        self.metadata = Metadata(n_local)
        self.metadata.set_label(labels)
        if weight is not None:
            self.metadata.set_weights(weight[owned])
        if qgroup is not None:
            self.metadata.set_group(qgroup)
        elif group is not None:
            self.metadata.set_group(group)
        self.bundle = None
        self._maybe_bundle(cfg, is_reference_linked=num_machines > 1)
        if num_machines > 1:
            self.global_rows = owned
            self.row_offset = 0
            self.num_data_global = n
        return self

    def _find_mappers_distributed(self, sample: np.ndarray, cfg: Config,
                                  categorical: Sequence[int], net) -> None:
        """``_find_mappers`` split over ``net``'s ranks: each finds the bins
        of its feature range (`dataset_loader.cpp:879-891`) over the whole
        sample, and the serialized mappers are allgathered
        (`dataset_loader.cpp:917-950`)."""
        import json

        from .io.distributed import _feature_ranges, _gather
        full = self.num_total_features
        start, length = _feature_ranges(full, int(net.num_machines))
        lo = start[net.rank]
        hi = lo + length[net.rank]
        self.num_total_features = hi - lo
        self._find_mappers(sample[:, lo:hi],
                           cfg, [c - lo for c in categorical
                                 if lo <= c < hi])
        mine = {int(j) + lo: m.to_dict()
                for j, m in zip(self.used_feature_map, self.bin_mappers)}
        self.num_total_features = full
        parts = _gather(net, json.dumps(mine), "bin-mapper")
        table = {int(j): d for p in parts for j, d in json.loads(p).items()}
        keep = sorted(table)
        self.bin_mappers = [BinMapper.from_dict(table[j]) for j in keep]
        self.used_feature_map = np.asarray(keep, dtype=np.int32)

    @classmethod
    def from_reference(cls, mat: np.ndarray, ref: "_ConstructedDataset",
                       cfg: Config) -> "_ConstructedDataset":
        """Validation data binned with the training set's mappers."""
        self = cls()
        mat = np.ascontiguousarray(mat, dtype=np.float64)
        n, f = mat.shape
        if f != ref.num_total_features:
            raise ValueError(f"validation data has {f} features, train has "
                             f"{ref.num_total_features}")
        self.num_data = n
        self.num_total_features = f
        self.feature_names = ref.feature_names
        self.config = ref.config
        self.metadata = Metadata(n)
        self.bin_mappers = ref.bin_mappers
        self.used_feature_map = ref.used_feature_map
        self._bin_all(mat, cfg, is_reference_linked=True)
        return self

    def _bin_all(self, mat: np.ndarray, cfg: Config,
                 is_reference_linked: bool = False) -> None:
        n = self.num_data
        block = max(int(cfg.tpu_row_block), 128)
        self.num_data_padded = _round_up(max(n, 1), block)
        self.max_num_bin = max((m.num_bin for m in self.bin_mappers), default=1)
        dtype = np.uint8 if self.max_num_bin <= 256 else np.uint16
        fu = len(self.bin_mappers)
        fu_pad = _round_up(max(fu, 1), self.FEATURE_TILE)
        self.bins = np.zeros((fu_pad, self.num_data_padded), dtype=dtype)
        for k, m in enumerate(self.bin_mappers):
            j = int(self.used_feature_map[k])
            self.bins[k, :n] = m.values_to_bins(mat[:, j]).astype(dtype)
        self.bundle = None
        self._maybe_bundle(cfg, is_reference_linked=is_reference_linked)

    def _maybe_bundle(self, cfg: Config, is_reference_linked: bool = False
                      ) -> None:
        """EFB over the binned matrix, gated as the compact learner consumes
        it (valid sets skip the exclusivity scan)."""
        if not is_reference_linked \
                and cfg.enable_bundle and cfg.tree_learner == "serial" \
                and cfg.tpu_learner in ("auto", "wave", "compact") \
                and self.max_num_bin <= 256 and len(self.bin_mappers) > 1:
            from .efb import apply_bundles, find_bundles
            groups = find_bundles(self, cfg)
            if any(len(g) > 1 for g in groups):
                self.bundle = apply_bundles(self, groups)

    # -- the binary cache: the JAX package's .npz layout (`dataset.h:394`
    #    SaveBinaryFile, `dataset_loader.cpp:266` LoadFromBinFile) ---------

    BINARY_VERSION = 1

    def save_binary(self, filename: str) -> None:
        """The codes, mappers and metadata as a compressed ``.npz`` (the
        JAX package's fields, so its ``load_binary`` reads it); written to a
        temporary name and renamed, so an interrupted save leaves no
        truncated cache."""
        import json
        import os

        md = self.metadata
        tmp = filename + ".tmp"
        with open(tmp, "wb") as fh:  # np.savez appends .npz to names
            np.savez_compressed(
                fh,
                lgbt_binary_version=np.int64(self.BINARY_VERSION),
                bins=self.bins,
                used_feature_map=self.used_feature_map,
                num_data=np.int64(self.num_data),
                num_total_features=np.int64(self.num_total_features),
                max_num_bin=np.int64(self.max_num_bin),
                feature_names=np.asarray(self.feature_names, dtype=object),
                mappers=np.asarray(
                    json.dumps([m.to_dict() for m in self.bin_mappers]),
                    dtype=object),
                label=md.label,
                weights=(md.weights if md.weights is not None
                         else np.zeros(0, np.float32)),
                query_boundaries=(md.query_boundaries
                                  if md.query_boundaries is not None
                                  else np.zeros(0, np.int32)),
                init_score=(md.init_score if md.init_score is not None
                            else np.zeros(0, np.float64)))
        os.replace(tmp, filename)

    @classmethod
    def load_binary(cls, filename: str, cfg: Config) -> "_ConstructedDataset":
        """A cache ``save_binary`` wrote, in either package.  As in the JAX
        package, no EFB bundle is looked for."""
        import json

        z = np.load(filename, allow_pickle=True)
        if int(z["lgbt_binary_version"]) > cls.BINARY_VERSION:
            raise ValueError("binary dataset written by a newer version")
        self = cls()
        self.config = cfg
        self.bins = z["bins"]
        self.used_feature_map = z["used_feature_map"]
        self.num_data = int(z["num_data"])
        self.num_data_padded = self.bins.shape[1]
        self.num_total_features = int(z["num_total_features"])
        self.max_num_bin = int(z["max_num_bin"])
        self.feature_names = [str(s) for s in z["feature_names"]]
        self.bin_mappers = [BinMapper.from_dict(d)
                            for d in json.loads(str(z["mappers"]))]
        self.metadata = Metadata(self.num_data)
        self.metadata.label = z["label"]
        if len(z["weights"]):
            self.metadata.weights = z["weights"]
        if len(z["query_boundaries"]):
            self.metadata.query_boundaries = z["query_boundaries"]
        if len(z["init_score"]):
            self.metadata.init_score = z["init_score"]
        return self

    @staticmethod
    def is_binary_file(path: str) -> bool:
        """True for a zip archive holding ``lgbt_binary_version``."""
        try:
            with open(path, "rb") as fh:
                if fh.read(2) != b"PK":
                    return False
            with np.load(path, allow_pickle=True) as z:
                return "lgbt_binary_version" in z
        except Exception:
            return False

    def device_bins(self, device):
        """Binned matrix as a uint8 (uint16 past 256 bins) tensor on
        ``device``, uploaded once per device."""
        import torch

        key = str(device)
        if key not in self._device_bins:
            self._device_bins[key] = torch.from_numpy(self.bins).to(device)
        return self._device_bins[key]

    @property
    def num_used_features(self) -> int:
        return len(self.bin_mappers)

    def feature_meta_arrays(self):
        """(num_bin, missing_type, default_bin, is_categorical) numpy arrays
        per used feature; cached."""
        if self._feature_meta is None:
            num_bin = np.array([m.num_bin for m in self.bin_mappers],
                               dtype=np.int32)
            missing = np.array([m.missing_type for m in self.bin_mappers],
                               dtype=np.int32)
            default_bin = np.array([m.default_bin for m in self.bin_mappers],
                                   dtype=np.int32)
            is_categorical = np.array([m.bin_type == BIN_CATEGORICAL
                                       for m in self.bin_mappers], dtype=bool)
            self._feature_meta = (num_bin, missing, default_bin, is_categorical)
        return self._feature_meta
