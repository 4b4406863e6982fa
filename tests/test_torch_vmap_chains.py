"""The user path: a model written UNBATCHED, lifted by vmap_chains
(nestmc_torch/model.py), sampled.

Twin of tests/test_vmap_chains.py (the conjugate normal model, 16 chains,
500/1000, posterior mean and sd within 0.05, R-hat < 1.02, the lifted
prior_sample's shape); its data are a {"y": tensor} dict because the port
takes the run's device from the data. Then: the lifted cond and joint of a
small unbatched hierarchical logistic model, and their autograd
gradients, equal nestmc.model.vmap_chains' (and jax.grad's) on the same
inputs (rtol = atol = 1e-5); MALA through torch.autograd under vmap; the
shapes the engine expects ((C,) for a scalar block, (C, U) for units);
per-chain init and prior draws; the error a vmap-unsafe hook gets;
with_loglik_impl and state_dtype.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from nestmc import distributions as jd
from nestmc import transforms as jtr
from nestmc.data import NestedData as JNestedData
from nestmc.model import Block as JBlock
from nestmc.model import ModelSpec as JModelSpec
from nestmc.model import state_dtype as j_state_dtype
from nestmc.model import vmap_chains as j_vmap_chains
from nestmc_torch import KernelConfig, RunConfig, SamplerConfig, sample
from nestmc_torch import distributions as td
from nestmc_torch import transforms as tr
from nestmc_torch.data import NestedData
from nestmc_torch.distributions import logpdf_normal
from nestmc_torch.model import Block, ModelSpec, state_dtype, vmap_chains
from nestmc_torch.rng import SweepRNG
from tests.test_torch_calibration import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
Y5 = np.array([0.4, 1.2, -0.3, 0.8, 1.5], np.float32)


def tiny_model():
    """tests/test_vmap_chains.py's model: y_i ~ N(theta, 1), theta ~
    N(0, 2), unbatched."""
    def cond(name, value, state, data):
        lik = torch.sum(logpdf_normal(data["y"], value, 1.0))
        return lik + logpdf_normal(value, 0.0, 2.0)

    return ModelSpec(
        name="tiny",
        blocks=(Block("theta", (), init_scale=1.0),),
        cond_logdensity=cond,
        joint_logdensity=lambda s, d: cond("theta", s["theta"], s, d),
        init_state=lambda rng, data, chains: {"theta": rng.normal(())},
        prior_sample=lambda rng, data, chains: {
            "theta": 2.0 * rng.normal(())},
    )


@pytest.mark.parametrize("algorithm", ["rwmh", "mala"])
def test_unbatched_model_lifted_and_sampled(algorithm):
    post_prec = len(Y5) + 1 / 4.0
    post_mean = Y5.sum() / post_prec
    post_sd = 1 / np.sqrt(post_prec)
    model = vmap_chains(tiny_model())
    post = sample(model, {"y": torch.from_numpy(Y5)}, SamplerConfig(
        kernel=KernelConfig(algorithm=algorithm),
        run=RunConfig(chains=16, warmup=500, draws=1000,
                      log_every_segment=False)))
    assert post.worst_rhat() < 1.02
    m = float(post.mean("theta"))
    sd = float(post.draws["theta"].std())
    assert abs(m - post_mean) < 0.05, (m, post_mean)
    assert abs(sd - post_sd) < 0.05, (sd, post_sd)
    pri = model.prior_sample(SweepRNG(0, "cpu"), None, 64)
    assert pri["theta"].shape == (64,)


# ---- a small unbatched hierarchical logistic model, in both packages ----

G, N, P, C = 5, 7, 3, 4


def hier_model(pkg):
    """beta_g ~ N(mu, tau), y_gi ~ Bernoulli(sigmoid(x_gi . beta_g)), mu ~
    N(0, 5), tau ~ HalfNormal(2) on the log transform: written for one
    chain with ``pkg``'s distributions and transforms."""
    xp, dist, lt_tr, mk, blk = (
        (jnp, jd, jtr.log_transform, JModelSpec, JBlock) if pkg == "jax"
        else (torch, td, tr.log_transform, ModelSpec, Block))

    def gprior(s):
        tau = lt_tr.forward(s["log_tau"])
        return xp.sum(dist.logpdf_normal(s["beta"], s["mu"], tau), -1)

    def lik(s, data):
        eta = xp.einsum("gnp,gp->gn", data.x, s["beta"])
        return xp.sum(dist.logpmf_bernoulli_logit(data.y, eta) * data.mask,
                      -1)

    def tau_prior(lt):
        return xp.sum(dist.logpdf_halfnormal(lt_tr.forward(lt), 2.0)
                      + lt_tr.log_jac(lt))

    def cond(name, value, state, data):
        s = {**state, name: value}
        if name == "beta":
            return lik(s, data) + gprior(s)
        if name == "mu":
            return xp.sum(gprior(s)) + xp.sum(
                dist.logpdf_normal(s["mu"], 0.0, 5.0))
        return xp.sum(gprior(s)) + tau_prior(s["log_tau"])

    def joint(s, data):
        return (xp.sum(lik(s, data) + gprior(s))
                + xp.sum(dist.logpdf_normal(s["mu"], 0.0, 5.0))
                + tau_prior(s["log_tau"]))

    return mk(
        name="user-hier-logistic",
        blocks=(blk("beta", (G, P), units=G, init_scale=0.3),
                blk("mu", (P,), init_scale=0.2),
                blk("log_tau", (P,), init_scale=0.2)),
        cond_logdensity=cond,
        joint_logdensity=joint,
        init_state=None,
    )


def hier_data():
    r = np.random.default_rng(3)
    ys, xs = [], []
    for g in range(G):
        n = int(r.integers(2, N + 1))
        x = r.normal(size=(n, P)).astype(np.float32)
        x[:, 0] = 1.0
        ys.append((r.random(n) < 0.5).astype(np.float32))
        xs.append(x)
    return JNestedData.from_ragged(ys, xs), NestedData.from_ragged(
        ys, xs, device="cpu")


def hier_state(seed=5):
    r = np.random.default_rng(seed)
    st = {"beta": 0.5 * r.normal(size=(C, G, P)),
          "mu": 0.3 * r.normal(size=(C, P)),
          "log_tau": -0.3 + 0.3 * r.normal(size=(C, P))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v) for k, v in st.items()})


def test_lifted_hooks_match_reference():
    jdata, tdata = hier_data()
    jm, tm = j_vmap_chains(hier_model("jax")), vmap_chains(hier_model("t"))
    js, ts = hier_state()
    jv, tv = hier_state(seed=6)
    for b in ("beta", "mu", "log_tau"):
        ours = tm.cond_logdensity(b, tv[b], ts, tdata)
        ref = np.asarray(jm.cond_logdensity(b, jv[b], js, jdata))
        assert ours.shape == ref.shape == ((C, G) if b == "beta" else (C,))
        np.testing.assert_allclose(ours.numpy(), ref, **TOL, err_msg=b)
    ours = tm.joint_logdensity(ts, tdata)
    ref = np.asarray(jm.joint_logdensity(js, jdata))
    assert ours.shape == (C,)
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)


@pytest.mark.parametrize("block", ["beta", "mu", "log_tau"])
def test_autograd_through_lifted_cond_matches_jax_grad(block):
    """kernels/mala.py differentiates the lifted cond with
    torch.autograd.grad; the gradient equals jax.grad of the reference's
    lifted cond summed over chains and units."""
    from nestmc_torch.kernels.mala import cond_value_and_grad

    jdata, tdata = hier_data()
    jm, tm = j_vmap_chains(hier_model("jax")), vmap_chains(hier_model("t"))
    js, ts = hier_state()
    val, grad = cond_value_and_grad(tm, block, ts[block], ts, tdata)
    jg = jax.grad(lambda v: jnp.sum(
        jm.cond_logdensity(block, v, js, jdata)))(js[block])
    assert grad.shape == ts[block].shape
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(
        val.numpy(), np.asarray(jm.cond_logdensity(block, js[block], js,
                                                   jdata)), **TOL)


def _with_init(spec):
    def init_state(rng, data, chains):
        return {"beta": 0.3 * rng.normal((G, P)), "mu": rng.normal((P,)),
                "log_tau": -0.5 + 0.1 * rng.normal((P,))}
    return dataclasses.replace(spec, init_state=init_state)


def test_mala_on_lifted_hierarchical_model():
    """A short MALA run on every block through autograd under vmap: the
    draws are finite, of the engine's shapes, and the acceptance of each
    block lies where MALA's adaptation puts it."""
    _, tdata = hier_data()
    model = vmap_chains(_with_init(hier_model("t")))
    post = sample(model, tdata, SamplerConfig(
        kernel=KernelConfig(algorithm="mala"),
        run=RunConfig(chains=8, warmup=150, draws=100, seed=4,
                      log_every_segment=False)))
    assert post.draws["beta"].shape == (8, 100, G, P)
    assert post.draws["mu"].shape == (8, 100, P)
    for v in post.draws.values():
        assert bool(torch.isfinite(v).all())
    for name, acc in post.accept_rates.items():
        assert 0.2 < float(acc.mean()) < 0.95, (name, float(acc.mean()))


def test_lifted_init_and_prior_draw_once_a_chain():
    spec = _with_init(hier_model("t"))
    spec = dataclasses.replace(spec, prior_sample=spec.init_state)
    model = vmap_chains(spec)
    st = model.init_state(SweepRNG(3, "cpu"), None, C)
    assert {k: tuple(v.shape) for k, v in st.items()} == {
        "beta": (C, G, P), "mu": (C, P), "log_tau": (C, P)}
    rng = SweepRNG(3, "cpu")
    for c in range(C):
        one = spec.init_state(rng, None, 0)
        for k in one:
            assert torch.equal(st[k][c], one[k]), (k, c)
    pri = model.prior_sample(SweepRNG(3, "cpu"), None, C)
    for k in st:
        assert torch.equal(pri[k], st[k])


def _unsafe(kind):
    captured = torch.zeros(())

    def cond(name, value, state, data):
        if kind == "item":
            return value * 0.0 + value.item()
        if kind == "branch":
            return value if value > 0 else -value
        captured.add_(value)
        return value

    return ModelSpec(
        name="unsafe", blocks=(Block("theta", ()),), cond_logdensity=cond,
        init_state=lambda rng, data, chains: {"theta": rng.normal(())})


@pytest.mark.parametrize("kind", ["item", "branch", "inplace"])
def test_vmap_unsafe_hook_raises_clear_error(kind):
    model = vmap_chains(_unsafe(kind))
    theta = torch.randn(4)
    with pytest.raises(RuntimeError, match="vmap_chains: cond_logdensity"):
        model.cond_logdensity("theta", theta, {"theta": theta}, None)


def test_with_loglik_impl_merges():
    spec = ModelSpec(name="m", blocks=(), init_state=lambda *a: {},
                     loglik_impls={"selected": "pallas", "a": 1})
    out = spec.with_loglik_impl(a=2, b=3)
    assert out.loglik_impls == {"selected": "pallas", "a": 2, "b": 3}
    assert spec.loglik_impls == {"selected": "pallas", "a": 1}
    assert dataclasses.replace(out, loglik_impls=spec.loglik_impls) == spec
    jspec = JModelSpec(name="m", blocks=(), cond_logdensity=None,
                       joint_logdensity=None, init_state=None,
                       loglik_impls={"selected": "pallas", "a": 1})
    assert jspec.with_loglik_impl(a=2, b=3).loglik_impls == out.loglik_impls


@pytest.mark.parametrize("case", ["float32", "mixed", "nested"])
def test_state_dtype_matches_reference(case):
    a = np.zeros((2, 3), np.float32)
    st = {"float32": {"a": a, "b": a[0]},
          "mixed": {"a": a, "i": np.zeros(2, np.int32)},
          "nested": {"a": {"b": a.astype(np.float64)}, "c": [a]}}[case]

    def conv(obj, f):
        if isinstance(obj, dict):
            return {k: conv(v, f) for k, v in obj.items()}
        if isinstance(obj, list):
            return [conv(v, f) for v in obj]
        return f(obj)

    with enable_x64() if case == "nested" else contextlib.nullcontext():
        ref = j_state_dtype(conv(st, jnp.asarray))
    ours = state_dtype(conv(st, torch.from_numpy))
    assert str(ours).split(".")[-1] == str(np.dtype(ref))

