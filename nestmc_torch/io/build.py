"""Build (and cache) the native CSV parser with the system's g++.

The parser (``nestmc_torch/native/ingest.cpp``) is a plain C-ABI shared
object loaded with ctypes. It is compiled with ``g++ -O3 -shared -fPIC`` at
first use into ``nestmc_torch/_build/native/`` (git-ignored), named by a
hash of the source and the flags, so a changed source rebuilds and an
unchanged one loads at once. Port of :mod:`nestmc.io.build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "native" / "ingest.cpp"
BUILD_DIR = _PKG / "_build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")

_CACHED: dict = {}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libnestmc_ingest_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *FLAGS, "-o", tmp, str(SRC)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def native_lib(rebuild: bool = False):
    """ctypes handle to the parser, or None if it cannot be built (the
    reason is in ``build_error()``)."""
    if "lib" in _CACHED and not rebuild:
        return _CACHED["lib"]
    _CACHED["error"] = None
    try:
        out = library_path()
        if rebuild or not out.exists():
            _compile(out)
        lib = ctypes.CDLL(str(out))
        lib.nestmc_ingest_csv.restype = ctypes.c_int
        lib.nestmc_ingest_csv.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _CACHED["lib"] = lib
    except Exception as e:  # no g++, a failed build or load
        _CACHED["lib"] = None
        _CACHED["error"] = f"{type(e).__name__}: {e}"
    return _CACHED["lib"]


def build_error() -> str | None:
    """Why the last :func:`native_lib` returned None, else None."""
    return _CACHED.get("error")
