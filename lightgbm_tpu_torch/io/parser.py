"""Text data loading: CSV / TSV / LibSVM with format auto-detection.

Port of ``lightgbm_tpu/io/parser.py`` (the reference's parser layer,
`src/io/parser.cpp/.hpp` + ``DatasetLoader::LoadFromFile``
`src/io/dataset_loader.cpp:160-264`): the delimiter and format come from the
first data line, a leading label column (or ``label_column=column_<i>``) is
split off, and the ``.weight`` / ``.query`` sidecar files are picked up as
``Metadata`` loading does (`src/io/metadata.cpp`).

Dense files (CSV, TSV, whitespace) are parsed by the port's host library
``csrc/parse.cpp`` (``parse_dense``, and ``parse_lines`` for the streaming
loader's chunks), built with the C++ compiler at first use
(``native.load_host``).  A dense file whose library cannot be built raises;
it is never parsed in Python.  LibSVM files take the numpy path, as the JAX
package sends them there.  Every value equals the JAX package's parse bit
for bit (``strtod`` and Python's ``float`` both round correctly).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Tuple

import numpy as np

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..native import load_host

        lib = load_host("parse")
        lib.lgbt_parse_dense.restype = ctypes.c_long
        lib.lgbt_parse_dense.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
        lib.lgbt_free.restype = None
        lib.lgbt_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
        lib.lgbt_parse_lines.restype = ctypes.c_long
        lib.lgbt_parse_lines.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char, ctypes.c_long,
            ctypes.c_long, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def parse_dense(path: str, delim: str = " ", skip_rows: int = 0
                ) -> np.ndarray:
    """Parse a dense delimited text file to an (rows, cols) float64 matrix
    (JAX ``native/__init__.py:parse_dense``).  ``delim`` ' ' means any run
    of spaces and tabs; otherwise a single-character delimiter, interior
    empty fields NaN, trailing delimiters ignored."""
    lib = _lib()
    data = ctypes.POINTER(ctypes.c_double)()
    rows, cols = ctypes.c_long(), ctypes.c_long()
    rc = lib.lgbt_parse_dense(os.fsencode(path), delim.encode(), skip_rows,
                              ctypes.byref(data), ctypes.byref(rows),
                              ctypes.byref(cols))
    if rc < 0:
        raise IOError(f"native parse of {path!r} failed (code {rc})")
    try:
        return np.ctypeslib.as_array(
            data, shape=(rows.value, cols.value)).copy()
    finally:
        lib.lgbt_free(data)


def parse_lines(lines, delim: str, cols: int) -> np.ndarray:
    """Dense data lines (no line ends) -> (len(lines), cols) float64: fields
    past ``cols`` dropped, missing ones NaN."""
    out = np.empty((len(lines), cols), dtype=np.float64)
    if not lines:
        return out
    buf = "\n".join(lines).encode()
    rc = _lib().lgbt_parse_lines(buf, len(buf), delim.encode(), len(lines),
                                 cols, out.ctypes.data)
    if rc < 0:
        raise IOError(f"native parse of a {len(lines)}-line chunk failed")
    return out


def _detect_format(first_lines) -> Tuple[str, str]:
    """Returns (kind, delimiter); kind in {csv, tsv, libsvm}."""
    line = first_lines[0]
    if "\t" in line:
        delim = "\t"
    elif "," in line:
        delim = ","
    else:
        delim = None  # whitespace
    toks = line.split(delim)
    for tok in toks[1:]:
        if ":" in tok:
            return "libsvm", delim or " "
    return ("tsv" if delim == "\t" else "csv"), delim or " "


def _has_header(params: Dict) -> bool:
    return str(params.get("header", params.get("has_header", "false"))
               ).lower() in ("true", "1")


def _resolve_label_idx(params: Dict) -> int:
    label_column = params.get("label_column", params.get("label", ""))
    if isinstance(label_column, str) and label_column.startswith("column_"):
        return int(label_column.split("_", 1)[1])
    return 0


def _data_lines(path: str, has_header: bool):
    """The file's non-empty lines without line ends, the header dropped."""
    skip = has_header
    with open(path) as fh:
        for raw in fh:
            if not raw.strip():
                continue
            if skip:
                skip = False
                continue
            yield raw.rstrip("\n\r")


def load_data_file(path: str, params: Optional[Dict] = None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray],
                              Optional[np.ndarray], Optional[np.ndarray]]:
    """(matrix, label, weight, group) of a text data file."""
    params = params or {}
    has_header = _has_header(params)
    first = next(iter(_data_lines(path, has_header)), None)
    if first is None:
        raise ValueError(f"no data rows in {path}")
    kind, delim = _detect_format([first])
    if kind == "libsvm":
        mat, label = _parse_libsvm(list(_data_lines(path, has_header)))
    else:
        mat = parse_dense(path, delim, 1 if has_header else 0)
        label_idx = _resolve_label_idx(params)
        label = mat[:, label_idx].copy()
        mat = np.delete(mat, label_idx, axis=1)
    return (mat, label, _load_sidecar(path + ".weight"),
            _load_sidecar(path + ".query"))


class StreamInfo:
    """Shape and format facts from one cheap ``scan_data_file`` pass: what
    the streaming loader needs to size its buffers and draw its sample
    before any matrix is built."""

    __slots__ = ("kind", "delim", "has_header", "label_idx", "num_rows",
                 "num_features")

    def __init__(self, kind: str, delim: str, has_header: bool,
                 label_idx: int, num_rows: int, num_features: int):
        self.kind = kind
        self.delim = delim
        self.has_header = has_header
        self.label_idx = label_idx
        self.num_rows = num_rows
        self.num_features = num_features


def scan_data_file(path: str, params: Optional[Dict] = None) -> StreamInfo:
    """Pass 0 of the streaming loader: the data row count and the format
    (``_detect_format`` on the first data line, as ``load_data_file``); for
    LibSVM also the largest feature index.  O(1) memory."""
    params = params or {}
    has_header = _has_header(params)
    kind = delim = None
    n = ncols = 0
    max_feat = -1
    for ln in _data_lines(path, has_header):
        if kind is None:
            kind, delim = _detect_format([ln])
        if kind == "libsvm":
            for tok in ln.split()[1:]:
                if ":" in tok:
                    max_feat = max(max_feat, int(tok.split(":", 1)[0]))
        elif n == 0:
            toks = ln.split() if delim == " " \
                else ln.rstrip(delim).split(delim)
            ncols = len(toks)
        n += 1
    if kind is None:
        raise ValueError(f"no data rows in {path}")
    num_features = (max_feat + 1) if kind == "libsvm" else max(ncols - 1, 0)
    return StreamInfo(kind, delim, has_header, _resolve_label_idx(params), n,
                      num_features)


def _parse_chunk(lines, info: StreamInfo) -> Tuple[np.ndarray, np.ndarray]:
    """One chunk of data lines -> (matrix, label), every value equal to an
    in-memory load of the whole file."""
    if info.kind == "libsvm":
        labels = np.empty(len(lines), dtype=np.float64)
        mat = np.zeros((len(lines), info.num_features), dtype=np.float64)
        for i, ln in enumerate(lines):
            toks = ln.split()
            labels[i] = float(toks[0])
            for tok in toks[1:]:
                if ":" not in tok:
                    continue
                k, v = tok.split(":", 1)
                mat[i, int(k)] = float(v)
        return mat, labels
    # the column count is the scan's first data line's; ragged rows pad with
    # NaN or are cut, as parse_dense does
    mat = parse_lines(lines, info.delim, info.num_features + 1)
    label = mat[:, info.label_idx].copy()
    return np.delete(mat, info.label_idx, axis=1), label


def iter_data_chunks(path: str, params: Optional[Dict] = None,
                     chunk_rows: int = 65536,
                     info: Optional[StreamInfo] = None):
    """The file as ``(start_row, matrix, label)`` chunks of at most
    ``chunk_rows`` rows, the streaming loader's passes; the chunks together
    equal ``load_data_file``'s (matrix, label)."""
    if info is None:
        info = scan_data_file(path, params)
    chunk_rows = max(int(chunk_rows), 1)
    start = 0
    buf: list = []
    for ln in _data_lines(path, info.has_header):
        buf.append(ln)
        if len(buf) >= chunk_rows:
            yield (start, *_parse_chunk(buf, info))
            start += len(buf)
            buf = []
    if buf:
        yield (start, *_parse_chunk(buf, info))


def _parse_libsvm(lines) -> Tuple[np.ndarray, np.ndarray]:
    labels = np.empty(len(lines), dtype=np.float64)
    rows = []
    max_feat = -1
    for i, ln in enumerate(lines):
        toks = ln.split()
        labels[i] = float(toks[0])
        feats = []
        for tok in toks[1:]:
            if ":" not in tok:
                continue
            k, v = tok.split(":", 1)
            k = int(k)
            feats.append((k, float(v)))
            max_feat = max(max_feat, k)
        rows.append(feats)
    mat = np.zeros((len(lines), max_feat + 1), dtype=np.float64)
    for i, feats in enumerate(rows):
        for k, v in feats:
            mat[i, k] = v
    return mat, labels


def _load_sidecar(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        vals = [float(x) for x in fh.read().split()]
    return np.asarray(vals, dtype=np.float64)
