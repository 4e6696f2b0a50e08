"""Binned training dataset: host binning, device-resident bin codes.

Port of ``lightgbm_tpu/dataset.py`` for in-memory numpy input.  Binning is
the same host numpy code (``binning.py``, ``efb.py``), so bin mappers and the
binned matrix are bit-identical to the JAX package's.  The layout is kept:

  * ``bins`` is ONE dense ``(features_padded, rows_padded)`` uint8/uint16
    numpy array; features pad to ``FEATURE_TILE`` (8) so the packed-word
    histogram sees whole 4-feature words, rows pad to ``tpu_row_block``.
  * ``device_bins(device)`` uploads it once per ``torch.device`` as a uint8
    tensor, uint16 past 256 bins (the JAX package's HBM-resident
    ``device_bins()``).  The card has few kernels for uint16, so consumers
    widen uint16 codes through ``ops/histogram.py:read_codes``.

Query groups (``group=``, per-query sizes) are stored as boundaries, as in
the JAX package.  Categorical features (``categorical_feature``: a list of
indices or names, ``"0,2"`` or ``"name:c1,c2"``) get the count-sorted
categorical bin mapper and stay out of EFB bundles.  Text files, binary
caches, streaming loads and training on pandas ``category`` columns are not
ported in this slice; they raise ``NotImplementedError``.  ``recode_pandas``
codes a predict-time DataFrame's ``category`` columns through a model's
stored category lists, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper, kZeroThreshold
from .config import SURFACE, Config, not_ported

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

    def construct(self) -> "Dataset":
        if self._constructed is None:
            cfg = Config.from_params(self.params)
            data = self._load_raw(self._raw_data)
            if self.reference is not None:
                ref = self.reference.construct()._constructed
                self._constructed = _ConstructedDataset.from_reference(
                    data, ref, cfg)
            else:
                self._constructed = _ConstructedDataset.from_matrix(
                    data, cfg, categorical=self._resolve_categorical(data),
                    feature_names=self._resolve_feature_names(data))
            md = self._constructed.metadata
            if self._label is not None:
                md.set_label(self._label)
            md.set_weights(self._weight)
            md.set_group(self._group)
            md.set_init_score(self._init_score)
            if self.free_raw_data:
                self._raw_data = None
        return self

    def _load_raw(self, data) -> np.ndarray:
        if isinstance(data, str):
            raise not_ported("text-file and binary-cache inputs", SURFACE)
        if hasattr(data, "toarray"):  # scipy sparse
            return np.asarray(data.toarray(), dtype=np.float64)
        if hasattr(data, "dtypes") and hasattr(data, "columns") \
                and not isinstance(data, np.ndarray):  # pandas DataFrame
            if any(str(t) == "category" for t in data.dtypes):
                raise not_ported("pandas categorical columns", SURFACE)
            return np.asarray(data.values, dtype=np.float64)
        return np.asarray(data, dtype=np.float64)

    def _resolve_feature_names(self, data) -> List[str]:
        if isinstance(self.feature_name, (list, tuple)):
            return list(self.feature_name)
        raw = self._raw_data
        if hasattr(raw, "columns"):
            return [str(c) for c in raw.columns]
        return [f"Column_{i}" for i in range(data.shape[1])]

    def _resolve_categorical(self, data) -> List[int]:
        """The categorical columns, sorted (JAX ``dataset.py:314-337``):
        ``categorical_feature`` as indices or names, else the config's
        ``categorical_feature`` (``"0,1,2"`` or ``"name:c1,c2"``)."""
        cf = self.categorical_feature
        if cf == "auto" or cf is None or cf == "":
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
