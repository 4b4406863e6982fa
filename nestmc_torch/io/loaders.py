"""Dataset loaders: CSV -> RaggedData (segment form).

Port of :mod:`nestmc.io.loaders`. CSV schema (headerless, numeric):
``group_id, y, x_1, ..., x_p`` with each group's rows contiguous; group ids
become 0..G-1 in order of first appearance. The native C++ parser
(nestmc_torch/native/ingest.cpp, built at first use by io/build.py) and the
numpy path give the same arrays. Both parse on the host; the arrays then go
to ``device``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from nestmc_torch.data import RaggedData, from_numpy_ragged


def _load_csv_python(path: str):
    raw = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    if raw.shape[1] < 2:
        raise ValueError("CSV needs at least (group_id, y) columns")
    gid = raw[:, 0]
    # dense group ids in first-appearance order (contiguous blocks)
    change = np.empty(len(gid), dtype=bool)
    if len(gid):
        change[0] = True
        change[1:] = gid[1:] != gid[:-1]
    seg = np.cumsum(change) - 1
    y = raw[:, 1].astype(np.float32)
    x = raw[:, 2:].astype(np.float32)
    return y, x, seg.astype(np.int32), int(seg[-1]) + 1 if len(seg) else 0


def _load_csv_native(path: str):
    """The parser's arrays, or None when it cannot be built."""
    from nestmc_torch.io.build import native_lib

    lib = native_lib()
    if lib is None:
        return None
    n_rows = ctypes.c_int64()
    n_cols = ctypes.c_int64()
    n_groups = ctypes.c_int64()
    err_line = ctypes.c_int64()
    rc = lib.nestmc_ingest_csv(
        path.encode(), ctypes.byref(n_rows), ctypes.byref(n_cols),
        ctypes.byref(n_groups), None, None, None, ctypes.byref(err_line),
    )
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise ValueError(
            f"CSV parse error (code {rc}) at line {err_line.value} in {path}"
        )
    R, C = n_rows.value, n_cols.value
    y = np.empty(R, np.float32)
    x = np.empty((R, C - 2), np.float32)
    seg = np.empty(R, np.int32)
    rc = lib.nestmc_ingest_csv(
        path.encode(), ctypes.byref(n_rows), ctypes.byref(n_cols),
        ctypes.byref(n_groups),
        y.ctypes.data_as(ctypes.c_void_p),
        x.ctypes.data_as(ctypes.c_void_p),
        seg.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(err_line),
    )
    if rc != 0:
        raise ValueError(f"CSV parse error on fill pass (code {rc})")
    return y, x, seg, n_groups.value


def load_csv(path: str, native: bool | None = None,
             device="cuda") -> RaggedData:
    """Load a ``group_id, y, x...`` CSV into RaggedData on ``device`` (the
    card unless the caller asks for another); a CSV without covariates
    gives an empty (N, 0) x.

    native: True requires the C++ parser (RuntimeError if it cannot be
    built); False forces the numpy path; None (default) uses the parser if
    it builds, else numpy.
    """
    out = None
    if native is not False:
        out = _load_csv_native(path)
        if out is None and native is True:
            from nestmc_torch.io.build import build_error

            raise RuntimeError(
                f"native ingest unavailable: {build_error()}")
    if out is None:
        out = _load_csv_python(path)
    y, x, seg, num_groups = out
    return from_numpy_ragged(x, y, seg, num_groups, device=device)
