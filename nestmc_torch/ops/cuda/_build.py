"""Build the CUDA sources in ``nestmc_torch/csrc`` and load them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into an object (one
``nvcc`` process per source, all started together) and links them into one
shared library with a plain C interface, specialised to one covariate count
p (``-DNESTMC_P=p``: the per-cell arrays of the kernels are sized at compile
time so they stay in registers). The library goes to ``nestmc_torch/_build/``
(git-ignored), named by a hash of the sources, the flags and p, so a changed
source rebuilds and an unchanged one loads at once; ptxas's report of each
kernel (registers, spills) goes beside it (``.log``). Nothing is built when
the package is imported: the first kernel launch builds, or :func:`build`
builds several p at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + (
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "nestmc_logp_grad": [_P] * 7 + [_I] * 3 + [_P],
    "nestmc_loglik": [_P] * 5 + [_I] * 3 + [_P],
    "nestmc_newton_step": [_P] * 21 + [_F] * 4 + [_I] * 3 + [_U] * 2
    + [_I, _P],
    "nestmc_mala_step": [_P] * 19 + [_F] * 4 + [_I] * 3 + [_U] * 2 + [_P],
    "nestmc_rwmh_step": [_P] * 13 + [_I] * 3 + [_U] * 2 + [_P],
    "nestmc_philox_probe": [_P, _P, _I, _U, _U, _P],
    "nestmc_pois_loglik": [_P] * 6 + [_I] * 3 + [_P],
    "nestmc_pois_logp_grad": [_P] * 8 + [_I] * 3 + [_P],
    "nestmc_pois_rwmh_step": [_P] * 14 + [_I] * 3 + [_U] * 2 + [_P],
    "nestmc_pois_mala_step": [_P] * 16 + [_I] * 3 + [_U] * 2 + [_P],
    "nestmc_pois_newton_step": [_P] * 18 + [_I] * 3 + [_U] * 2 + [_I, _P],
    "nestmc_seg_loglik": [_P] * 5 + [_I] * 2 + [_P],
    "nestmc_seg_logp_grad": [_P] * 6 + [_I] * 2 + [_P],
    "nestmc_tile_plan": [_I, _I, _P],
}

_libs: dict = {}
build_info: dict = {}  # p -> {"path", "seconds", "log"} of builds this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path(p: int) -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + f"p={p}".encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libnestmc_p{p}_{h.hexdigest()[:16]}.so"


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def _compile(p: int, out: Path) -> None:
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmpdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    try:
        objs = [tmpdir / (f.stem + ".o") for f in cu]
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, f"-DNESTMC_P={p}", f"-I{SRC_DIR}",
                 "-c", "-o", str(o), str(f)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for f, o in zip(cu, objs)
        ]
        outs = [proc.communicate() for proc in procs]  # wait for all
        for f, proc, (so, se) in zip(cu, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {f.name} ({proc.returncode}):\n{so}\n{se}"
                )
        logs = [se for _, se in outs]
        lib = tmpdir / "lib.so"
        r = _run([_nvcc(), *ARCH, "-shared", "-o", str(lib), *map(str, objs)])
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({r.returncode}):\n{r.stdout}\n{r.stderr}"
            )
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(lib, out)  # atomic: a reader never sees a partial file
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    build_info[p] = {
        "path": str(out),
        "seconds": time.perf_counter() - t0,
        "log": "\n".join(logs),
    }


def build(ps) -> None:
    """Build (or find) the libraries for every p in ``ps`` at once."""
    with ThreadPoolExecutor(max_workers=max(1, len(ps))) as ex:
        list(ex.map(library, ps))


def library(p: int) -> ctypes.CDLL:
    """The kernel library for covariate count p, built on first use from
    the sources in ``SRC_DIR`` (another tree's for an A/B, see
    nestmc_torch.kernel_ab)."""
    lib = _libs.get((p, SRC_DIR))
    if lib is not None:
        return lib
    if not 1 <= p <= 8:
        raise ValueError(f"the CUDA kernels take 1 <= p <= 8, got p={p}")
    out = library_path(p)
    if not out.exists():
        _compile(p, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)   # None: an older tree's library
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _libs[(p, SRC_DIR)] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
