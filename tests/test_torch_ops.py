"""nestmc_torch ops vs the JAX reference on identical numpy inputs.

smallchol (random SPD, p in {1, 3, 4, 8}) and the three logistic obs
passes: the port's plain versions (and its kernel wrappers, which run them
for CPU tensors) vs nestmc.ops.loglik and vs the Pallas kernels in
interpret mode. Tolerance rtol 1e-5, atol 1e-4 (float32 sums over n obs in
different orders). Also: the port imports no JAX, and the wrappers refuse
devices they have no kernel for.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestmc.ops import loglik as jl
from nestmc.ops import smallchol as jsc
from nestmc.ops.pallas.loglik_logistic import (
    logistic_logp_grad_hess_pallas,
    logistic_logp_grad_pallas,
)
from nestmc_torch.ops import loglik as tl
from nestmc_torch.ops import smallchol as tsc
from nestmc_torch.ops.cuda import _build
from nestmc_torch.ops.cuda.loglik_logistic import (
    logistic_logp_grad,
    logistic_logp_grad_hess,
)
from tests.test_torch_calibration import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-4)


def _close(a, b, **tol):
    np.testing.assert_allclose(
        np.asarray(a, np.float32), np.asarray(b, np.float32), **(tol or TOL)
    )


def _spd(p, batch=(5, 3), seed=0):
    r = np.random.default_rng(seed + p)
    a = r.standard_normal(batch + (p, p)).astype(np.float32)
    m = a @ np.swapaxes(a, -1, -2) + p * np.eye(p, dtype=np.float32)
    return m


@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_smallchol_matches_reference(p):
    m = _spd(p)
    packed = np.array(jsc.pack_dense(jnp.asarray(m), p))
    _close(tsc.pack_dense(torch.as_tensor(m), p), packed)
    _close(tsc.unpack_dense(torch.as_tensor(packed), p), m)
    r = np.random.default_rng(7)
    b = r.standard_normal(m.shape[:-1]).astype(np.float32)
    Lj = jsc.chol_packed(jnp.asarray(packed), p)
    Lt = tsc.chol_packed(torch.as_tensor(packed), p)
    _close(Lt, Lj)
    bj, bt = jnp.asarray(b), torch.as_tensor(b)
    for name in ("solve_lower", "solve_upper_t", "spd_solve", "lt_vec"):
        _close(getattr(tsc, name)(Lt, bt, p), getattr(jsc, name)(Lj, bj, p))
    _close(tsc.half_logdet(Lt, p), jsc.half_logdet(Lj, p))
    d = np.abs(b) + 0.5
    _close(tsc.pack_diag(torch.as_tensor(d), p),
           jsc.pack_diag(jnp.asarray(d), p))
    assert tsc.packed_dim(p) == jsc.packed_dim(p)
    assert tsc.diag_indices(p) == jsc.diag_indices(p)


def _obs_inputs(C=6, G=7, n=11, p=3, seed=3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((G, n, p)).astype(np.float32)
    x[:, :, 0] = 1.0
    mask = np.ones((G, n), np.float32)
    mask[0, n - 4:] = 0.0
    mask[3, n - 1:] = 0.0
    y = (r.random((G, n)) < 0.5).astype(np.float32) * mask
    beta = (0.7 * r.standard_normal((C, G, p))).astype(np.float32)
    return beta, x, y, mask


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("p", [1, 3, 4])
def test_obs_passes_match_jnp_reference(p):
    beta, x, y, mask = _obs_inputs(p=p)
    jb, jx, jy, jm = map(jnp.asarray, (beta, x, y, mask))
    tb, tx, ty, tm = _torch(beta, x, y, mask)
    _close(tl.logistic_loglik_padded(tb, tx, ty, tm),
           jl.logistic_loglik_padded(jb, jx, jy, jm))
    ref = jl.logistic_logp_grad_hess_padded(jb, jx, jy, jm)
    for a, b in zip(tl.logistic_logp_grad_hess_padded(tb, tx, ty, tm), ref):
        _close(a, b)
    for a, b in zip(tl.logistic_logp_grad_padded(tb, tx, ty, tm), ref[:2]):
        _close(a, b)


@pytest.mark.parametrize("dense", [False, True])
def test_obs_pass_wrappers_match_pallas_interpret(dense):
    beta, x, y, mask = _obs_inputs()
    if dense:
        mask = np.ones_like(mask)
    jargs = [jnp.asarray(a) for a in (beta, x, y, mask)]
    targs = _torch(beta, x, y, mask)
    ref = logistic_logp_grad_pallas(*jargs, interpret=True, dense=dense)
    for a, b in zip(logistic_logp_grad(*targs), ref):
        _close(a, b)
    ref = logistic_logp_grad_hess_pallas(*jargs, interpret=True, dense=dense)
    out = logistic_logp_grad_hess(*targs)
    assert [tuple(o.shape) for o in out] == [tuple(r.shape) for r in ref]
    for a, b in zip(out, ref):
        _close(a, b)


def test_wrappers_refuse_devices_without_a_kernel():
    beta, x, y, mask = (t.to("meta") for t in _torch(*_obs_inputs()))
    with pytest.raises(RuntimeError, match="no kernel"):
        logistic_logp_grad(beta, x, y, mask)
    with pytest.raises(RuntimeError, match="no kernel"):
        logistic_logp_grad_hess(beta, x, y, mask)


def test_build_errors_raise(monkeypatch, tmp_path):
    with pytest.raises(ValueError):
        _build.library(9)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        _build.check(2, "launch")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library(4)


def test_library_path_keys_on_p_and_sources():
    a, b = _build.library_path(3), _build.library_path(4)
    assert a != b and a.parent == b.parent == _build.BUILD_DIR
    assert _build.library_path(4) == b


def test_port_imports_no_jax():
    code = (
        "import sys, nestmc_torch, nestmc_torch.bench, nestmc_torch.models,"
        " nestmc_torch.presets, nestmc_torch.prof;"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'nestmc')];"
        "assert not bad, bad"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_distributions_match_reference():
    from nestmc import distributions as jdist
    from nestmc_torch import distributions as tdist

    r = np.random.default_rng(2)
    x = r.standard_normal(50).astype(np.float32) * 3
    loc, scale = np.float32(0.4), np.abs(x[::-1]) + 0.2
    _close(tdist.logpdf_normal(torch.as_tensor(x), float(loc),
                               torch.as_tensor(scale)),
           jdist.logpdf_normal(jnp.asarray(x), loc, jnp.asarray(scale)))
    _close(tdist.logpdf_normal(torch.as_tensor(x), 0.0, 5.0),
           jdist.logpdf_normal(jnp.asarray(x), 0.0, 5.0))
    ax = np.abs(x)
    _close(tdist.logpdf_halfnormal(torch.as_tensor(ax), 2.0),
           jdist.logpdf_halfnormal(jnp.asarray(ax), 2.0))
    lt = np.array([-13.0, -11.9, 0.0, 11.9, 12.0, 13.0], np.float32)
    np.testing.assert_array_equal(
        tdist.log_scale_guard(torch.as_tensor(lt)).numpy(),
        np.asarray(jdist.log_scale_guard(jnp.asarray(lt))),
    )
