"""The hierarchical logistic model (``nestmc_torch.models.make_hier_logistic``)
on balanced groups: every part of the benchmark that knows this model.

A configuration names it by ``"model": "hier_logistic"``; its keys
``groups``, ``obs_per_group`` and ``covariates`` give the data's (G, n, p),
the rest the model's priors and the sampler's settings. The plain
reference of its sweep and its data generator are in
``hier_logistic_reference.py`` beside this file, which imports nothing of
the program; this file imports the program inside :func:`build` and
:func:`prepare` only.
"""

from __future__ import annotations

import re

from portbench import check, roofline
from portbench.models import hier_logistic_reference as R
from portbench.reference import no_tf32

# key word pairs a sweep takes from the host generator: one launch of the
# fused step on the card, two fills on the CPU
KEYS = R.KEYS

# the interweaving move's kernels (csrc/asis_move.cu), hand-written besides
# the step and likelihood kernels that roofline.HAND_WRITTEN names
HAND_WRITTEN = ("asis_stats_kernel", "asis_propose_kernel",
                "asis_accept_kernel")
_ASIS = re.compile(r"\b(asis_(?:stats|propose|accept))_kernel\b")


# ---- the run ----

def data(cfg: dict) -> dict:
    """The configuration's arrays: the frozen generator at its
    ``data_seed``."""
    return R.synth_logistic(cfg["data_seed"], cfg["groups"],
                            cfg["obs_per_group"], cfg["covariates"])


def build(cfg: dict, traffic: dict, arrays: dict, seed: int, device):
    """(model, data, SamplerConfig) through the program's public
    constructors, with the configuration's values and the traffic's
    sharding; ``seed`` seeds the chains."""
    from nestmc_torch import (
        KernelConfig,
        RunConfig,
        SamplerConfig,
        ShardingConfig,
        from_numpy,
    )
    from nestmc_torch.models import make_hier_logistic

    c, tr = cfg, traffic
    dat = from_numpy(arrays["x"], arrays["y"], arrays["mask"],
                     device=device)
    model = make_hier_logistic(
        dat, prior_mu_scale=c["prior_mu_scale"],
        prior_tau_scale=c["prior_tau_scale"], tau_prior=c["tau_prior"],
        tau_ig_shape=c["tau_ig_shape"], tau_ig_scale=c["tau_ig_scale"],
        asis_repeats=c["asis_repeats"])
    sampler = SamplerConfig(
        kernel=KernelConfig(algorithm=c["algorithm"], fused_accept=True),
        run=RunConfig(chains=c["chains"], warmup=c["warmup"], draws=0,
                      thin=c["thin"], seed=seed,
                      segment_size=c["segment_size"],
                      collect=dict(c["collect"]), full_rhat=True,
                      full_rhat_thin=c["full_rhat_thin"],
                      log_every_segment=False),
        sharding=ShardingConfig(chain_shards=tr["chain_shards"],
                                group_shards=tr["group_shards"]))
    return model, dat, sampler


def prepare(cfg: dict) -> None:
    """The program's kernel library for p covariates, built on a
    checkout's first run and loaded (before the warmup's clock)."""
    from nestmc_torch.ops.cuda import _build

    _build.library(int(cfg["covariates"]))


def shapes(cfg: dict, carry) -> dict:
    """{'C', 'G', 'n', 'p'} of this process's part of the cell, read from
    its carry."""
    C, G = carry.position["beta"].shape[:2]
    return {"C": int(C), "G": int(G), "n": cfg["obs_per_group"],
            "p": cfg["covariates"]}


def parameters(cfg: dict) -> int:
    """The parameters the streamed R-hat covers (a run's ``attempted``):
    beta (G, p), mu and log tau."""
    return (int(cfg["groups"]) + 2) * int(cfg["covariates"])


def tiny(cfg: dict) -> dict:
    """The configuration cut to a size the CPU tests can run."""
    return dict(cfg, chains=16, warmup=40, obs_per_group=10,
                segment_size=8,
                groups=16 if cfg["algorithm"] == "newton" else 24)


# ---- the check ----

def reference(cfg: dict, arrays: dict, device, tf32: bool = False):
    """The plain reference of the model on the configuration's data;
    ``tf32``: the control."""
    model = R.Model(cfg, R.Data(arrays, device))
    model.tf32 = tf32
    return model


def ref_state(s) -> dict:
    """The reference's view of a carry: positions and log scales."""
    ls = s.log_scale
    return {"beta": s.position["beta"], "mu": s.position["mu"],
            "log_tau": s.position["log_tau"],
            "log_scale_beta": ls["beta"],
            "log_scale_lt": ls.get("log_tau"),
            "log_scale_asis": ls.get("asis_tau")}


def outputs(model, taken: check.Taken, cfg: dict, device) -> dict:
    """What ``model`` works out from ``taken``: {'first', 'late': the
    collected scalars of the window's first draw and of draw k, 'warm':
    the state after the last warmup sweep, 'carry': the caches of the
    window's starting positions}."""
    collect = {k: v for k, v in cfg["collect"].items() if v is not None}
    warmup = int(cfg["warmup"])
    mode = check.mode(device)
    C = taken.s0.position["beta"].shape[0]

    def noise(state):
        return R.Noise(model, C, state["host"], state["device"], device,
                       mode)

    with no_tf32():
        cache = R.carry(model, taken.s0.position["beta"])
        h = cache.get("h")
        st0 = ref_state(taken.s0)
        first = R.collected(R.sweep(model, st0, noise(taken.snapshot),
                                    h=h), collect)
        stk = dict(st0, **{k: taken.sk.position[k]
                           for k in ("beta", "mu", "log_tau")})
        late = R.collected(R.sweep(model, stk, noise(taken.snap_k), h=h),
                           collect)
        warm = R.sweep(model, ref_state(taken.sw), noise(taken.snap_w),
                       warmup=True, t=warmup - 1)
    return {"first": first, "late": late, "warm": warm, "carry": cache}


def program_outputs(taken: check.Taken, draws: dict) -> dict:
    """The same quantities as the program made them."""
    return {"first": {k: v[:, 0] for k, v in draws.items()},
            "late": {k: v[:, taken.k] for k, v in draws.items()},
            "warm": ref_state(taken.s0),
            "carry": taken.s0.cache["beta"]}


# ---- the counts ----

def kernel_work(kernel: str, C: int, G: int, n: int, p: int,
                noise: bool = False, fold: bool = False) -> tuple:
    """(bytes, float32 operations) one call of ``kernel`` needs on (C, G)
    cells of n observations and p covariates (a frozen copy of the
    program's counts, utils/profiling.kernel_work): the data x, y, mask
    once, each per-cell input and output once (external noise when
    ``noise``; the (2, G, p, C) R-hat accumulators read and written when
    ``fold``); per obs-cell 2p (eta) + 9 (logistic value terms) [+ 2p + 8
    (gradient terms)] [+ 3T (Hessian)] operations, per cell the step's own
    algebra. ``kernel``: loglik, logp_grad, logp_grad_hess, rwmh_step,
    mala_step, newton_step (refresh) or newton_step_frozen."""
    T = p * (p + 1) // 2
    cells, obs = C * G, C * G * n
    data = 4 * G * n * (p + 2)
    hyper = 8 * C * p
    f = 4 * 2 * G * p * C if fold else 0
    nz = 4 * cells * (p + 1) if noise else 0
    val_ops = 2 * p + 9
    grad_ops = val_ops + 2 * p + 8
    hess_ops = 3 * T
    if kernel == "loglik":
        return data + 4 * cells * (p + 1), obs * val_ops
    if kernel == "logp_grad":
        return data + 4 * cells * (2 * p + 1), obs * grad_ops
    if kernel == "logp_grad_hess":
        return (data + 4 * cells * (2 * p + 1 + T),
                obs * (grad_ops + hess_ops))
    if kernel == "rwmh_step":
        return (data + hyper + nz + 4 * cells * (2 * p + 4),
                obs * val_ops + cells * (8 * p + 6))
    if kernel == "mala_step":
        return (data + hyper + nz + 4 * f + 4 * cells * (4 * p + 4),
                obs * grad_ops + cells * (16 * p + 12 + (8 * p if fold
                                                         else 0)))
    if kernel in ("newton_step", "newton_step_frozen"):
        frozen = kernel == "newton_step_frozen"
        h = 0 if frozen else 4 * cells * T
        return (data + hyper + nz + 4 * f + 4 * cells * (4 * p + 4 + T) + h,
                obs * (grad_ops + (0 if frozen else hess_ops))
                + cells * (4 * p ** 3 + 30 * p + (8 * p if fold else 0)))
    raise KeyError(kernel)


def asis_work(kernel: str, C: int, G: int, p: int, n: int = 0) -> tuple:
    """(bytes, float32 operations) one call of an interweaving move's
    kernel needs on C chains of G groups (a frozen copy of the program's
    counts, utils/profiling.kernel_work's asis_* branch): for asis_stats
    ``n`` is the floats it reads a (chain, group) cell (beta and g, the
    Hessian's T when every chain has its own, the two loglik rows at the
    proposal; a Hessian bound shared by the chains is read from L2, not
    counted); asis_propose reads beta and writes beta' besides its
    per-chain algebra; asis_accept is per-chain algebra alone."""
    T, q = p * (p + 1) // 2, 2 * p
    K = 2 * p + 2 * T + p * p + 1
    algebra = q ** 3 // 3 + 4 * q * q + 20 * q   # a factor, three solves
    if kernel == "asis_stats":
        return (4 * C * G * n + 4 * C * (2 * p + 1 + K),
                C * G * (2 * p * p + 5 * p + 4 * T + 2))
    if kernel == "asis_propose":
        return (8 * C * G * p + 4 * C * (K + 7 * p + 1),
                C * algebra + 3 * C * G * p)
    if kernel == "asis_accept":
        return 4 * C * (K + 7 * p + 5), C * algebra
    raise KeyError(kernel)


def kernel_call(name: str) -> tuple | None:
    """(kernel_work name, noise, fold) of a step or likelihood kernel's
    device name, read from the template arguments the profiler prints
    with it; None for a kernel of another family (the Poisson family), one
    this model does not count (the segment pass, the noise fill) or a name
    without them."""
    t = roofline.template(name)
    if t is None or "Logit" not in t[1]:
        return None
    base, _, flags = t
    if base == "newton_step_kernel":
        return ("newton_step_frozen" if flags["FROZEN"] else "newton_step",
                flags["EXT"], flags["FOLD"])
    if base == "mala_step_kernel":
        return ("mala_step", flags["EXT"], flags["FOLD"])
    if base == "rwmh_step_kernel":
        return ("rwmh_step", flags["EXT"], False)
    if base == "logp_grad_kernel":
        return ("logp_grad_hess" if flags["HESS"] else "logp_grad", False,
                False)
    if base == "loglik_kernel":
        return ("loglik", False, False)
    return None


def launch_work(name: str, ordinal: int, cfg: dict,
                s: dict) -> tuple | None:
    """(bytes, float32 operations) of one launch of the device kernel
    ``name``, the ``ordinal``-th (from 0) of that name in its sweep, at
    this process's shapes ``s``; None for a launch this model does not
    count. The move's two asis_stats launches: at the current point (0),
    then at the proposal (1), which reads the two loglik rows as well;
    each reads each chain's Hessian under Newton-MH and a bound that the
    chains share under MALA."""
    m = _ASIS.search(name)
    if m is not None:
        n = 0
        if m.group(1) == "asis_stats":
            T = s["p"] * (s["p"] + 1) // 2
            n = (2 * s["p"] + (T if cfg["algorithm"] == "newton" else 0)
                 + (2 if ordinal % 2 else 0))
        return asis_work(m.group(1), s["C"], s["G"], s["p"], n)
    call = kernel_call(name)
    if call is None:
        return None
    kernel, noise, fold = call
    return kernel_work(kernel, s["C"], s["G"], s["n"], s["p"], noise=noise,
                       fold=fold)


def sweep_work(cfg: dict, s: dict) -> tuple:
    """(bytes, float32 operations) of the least work of one sweep of the
    configured algorithm: one group step in its sampling mode and one
    interweave logp_grad pass, whatever kernels run them."""
    fold = cfg["full_rhat_thin"] == 1
    step = {"newton": "newton_step_frozen", "mala": "mala_step"}[
        cfg["algorithm"]]
    work = [kernel_work(step, s["C"], s["G"], s["n"], s["p"], fold=fold),
            kernel_work("logp_grad", s["C"], s["G"], s["n"], s["p"])]
    return sum(b for b, _ in work), sum(o for _, o in work)
