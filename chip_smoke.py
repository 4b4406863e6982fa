"""GPU smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA card and this checkout (it builds the kernels from
``nestmc_torch/csrc``). Phases, one line or more each:

1. the card: nvidia-smi's name and power limit, torch's device name;
2. the kernel build (nvcc, sm_90a) for p=4 and p=3 at once, seconds each,
   and ptxas's registers and spills of every kernel;
3. each kernel vs its plain PyTorch version, with external noise, at the
   shapes its paths give it: config 3's shape (C=512 chains, S=4000
   subjects, n=10, p=3) for the seven Poisson launch modes (the three obs
   passes; the RW, MALA and Newton refresh and frozen subject steps); the
   judged shape (C=1024, G=1000, n=50, p=4)
   for the Newton path's kernels; the mala-100k shape (C=512, G=100,000,
   n=20, p=3) for mala_step, logp_grad, rwmh_step and loglik, where the
   outputs are compared with the plain version on the first 64 chains
   (cells are independent per chain, so the comparison is exact; the plain
   version's (C, G, n) temporaries are 4.1 GB each at full width); the RW
   preset's shape (C=64, G=100, n=50, p=4) for rwmh_step and loglik;
   config 4's data (ragged-10k at seed 0: C=1024, G=10,000 groups of 5..30
   obs, N about 175,000, p=3) for the two segment kernels (tolerance
   |a-b| <= 2e-5 + rtol |b|, rtol 2e-5 for the loglik and 2e-4 for the
   gradient, the reference's segment contract), with a small case of
   empty groups and a group of more observations than one staged chunk,
   and the widest size bucket of that data (C=1024, about 5,400 groups,
   cap 32, p=3) for the bucketed route's obs passes and Newton and MALA
   steps; then (3d) the tiled templates (logp_grad, logp_grad_hess, the
   value-only loglik, the RW-MH step, the MALA step, the Newton step
   refresh and frozen, with and without the fold; Logit and Poisson) at
   partial tiles and odd sizes for p=3 and p=4 (C, G, n from 1 to 130,
   70, 50, and n=3000 for one unit a tile),
   and the segment kernels' tile at its edges (a group longer than a
   chunk, a group straddling two chunks, empty groups, G and C off the
   tile, one chain); then (3e) the Newton path's kernels (logp_grad,
   logp_grad_hess, newton_step refresh, frozen and frozen+fold) at config
   2's shape (C=64, G=100, n=50, p=4), the 1k-group presets' (C=256,
   G=1000, n=50, p=4; with mala_step's fold mode for -mala) and
   mala-100k-newton's (the mala-100k shape; parity and plain version on
   the first 64 chains), timed with Philox noise (the main paths' mode)
   as extra "cells" of each kernel's record, and the value-only loglik at
   the judged and 1k-group shapes (where group_loglik collection launches
   it once a retained draw); (3f) the binomial family's operands at
   config 2's shape (the mask a trials weight, integers 0..10 with
   zero-weight runs inside groups, y the fraction of successes: what
   models/hier_glm.py's binomial delegate feeds the logistic kernels) for
   loglik, logp_grad and newton_step refresh and frozen+fold, as more
   cells. mala_step's record times the
   main path's mode at mala-100k (Philox noise, no fold; bound without the
   noise operands) and keeps the external-noise time beside it. Dense and
   masked data, with and without the R-hat fold. Each line: the max error
   against the stated tolerance (1e-3 + 1e-4 |ref| where no other is
   said), the accept decisions that differ (all must lie within
   |log alpha - log u| < 1e-3), both times (CUDA
   events; median over 7 batches of 10 back-to-back launches, after
   warm-up; the plain version at full width unless it runs out of memory,
   then on the slice, which the line says) and the bound (below);
4. the moments of the in-kernel Philox normals and uniforms;
5. small-input references: the hierarchical logistic (Newton, MALA,
   RW-MH; on ragged data Newton on the bucket route and MALA on the
   segment route) and nested Poisson (RW-MH, MALA, Newton) samplers on
   the card vs their plain versions on the CPU (posterior means of the
   population parameters within 4 combined MCSEs, mean beta / beta_s
   acceptance within 0.05);
6. the end-to-end paths at full width, launch counters reset just before
   each and read just after: the RW-MH preset (hier-logistic-100-rw),
   config 2 (hier-logistic-100: frozen-metric Newton-MH), config 1
   (eight-schools: plain PyTorch, no launch; its posterior mu, tau and
   theta against a dense float64 quadrature of the posterior within 6
   standard errors), the exactness tier (the conjugate normal model's
   posterior moments within 5 standard errors of the closed form, as
   tests/test_torch_exactness.py), config 3 (nested-poisson-1k), config 4
   (ragged-10k: Newton-MH per size bucket; these five at full schedule,
   never cut), config 5's Newton variant (mala-100k-newton at full width,
   200/300 sweeps: its launches asserted, its R-hat printed), config 5
   (mala-100k), config 4's data on the segment-kernel
   route (ragged-10k-mala's model built with loglik_impl='pallas-segment':
   MALA, then RW-MH on a short schedule whose R-hat is printed, not
   asserted), config 3's MALA and Newton variants and the judged config.
   Each must launch exactly its kernels, as many times as its schedule
   implies, reach worst all-parameter R-hat < 1.01, a plausible
   acceptance of its MH-updated block and no NaN. When the time budget
   requires, depth is cut (never width), and the R-hat line is then
   printed, not asserted: first config 3's variants, then the segment
   MALA path (each runs its full schedule only if the script would still
   end within 60% of its budget), then the judged run; mala-100k's draws
   only if even minimal other runs would not fit. The script says so.
   Phases 7, 8 and 9 run after the fixed paths (the five configs and
   mala-100k-newton) and before the cut ones (mala-100k, the segment
   paths, config 3's variants, judged), so each cut is decided on the
   time actually left, whatever the host's speed;
7. the command line (nestmc_torch/cli.py, in-process ``cli.main``, on the
   card by default), launch counters reset just before each call and read
   just after: (a) ``run --preset hier-logistic-100`` at full width and
   schedule collecting mu, log_tau, beta:8 and group_loglik, a checkpoint
   every 1024 sweeps or draws, --save-draws and --metric-json: the Newton
   path's launches plus exactly one loglik a retained draw, the gate over
   all 408 parameters, group_loglik (64, 4096, 100) against the plain pass
   on the collected groups' betas at four draws, the time of one
   collection; (b) the checkpoints cut after the second sample segment and
   ``run --resume``: only the remaining 2048 draws run (plus the
   template's one Hessian pass), the finalized all-parameter R-hat of
   every block equals the uninterrupted run's within 1e-5 (bitwise
   printed); a judged-size checkpoint written and loaded (MB, ms); (c)
   ``run --preset hier-logistic-100-rw`` on the same data (depth cut only
   if the budget demands it) and ``compare`` of the two npz files by
   PSIS-LOO and WAIC: finite elpd, k_hat > 0.7 counts printed; (d) config
   3's subject_loglik and group_loglik on the card vs the CPU's plain
   version at one position, timed as a pois_loglik cell; (e) ``python -m
   nestmc_torch list-presets`` in its own process;
8. the generic hierarchical GLM, posterior-predictive checks and the CSV
   loader (models/hier_glm.py, predictive.py, io/), on the card, launch
   counters reset just before each run and read just after: (a) the
   binomial family at config 2's width (synth_glm G=100, n=50, p=4, 10
   trials, 64 chains, invgamma tau, frozen Newton 1500/4096, beta and
   group_loglik collected in full): config 2's launches plus one loglik a
   retained draw (the reweighting adds none), the gate over 408
   parameters, group_loglik at four draws against the plain pass plus the
   log binomial coefficient; (d) posterior_predictive on its draws: 64
   replicates (64, 100, 50) of counts in [0, 10], the masked-mean p-value
   in (0.02, 0.98), timed; (b) the poisson family at config 3's unit width
   (G=4000, n=10, p=3, 512 chains): Newton at 1000/2048 (the Poisson
   steps' and obs passes' exact counts; its R-hat and the units its Laplace
   proposal traps printed, not asserted) and MALA at 2000/16384 (exact
   counts, the gate over 12,006 parameters); (c)
   gaussian and negbin at config 2's width (plain PyTorch, Newton on the
   zero-self split, 500/1024: no launch, the gate, mu and the aux block's
   posterior means within 4 posterior sds of synth_glm's truth); (e) a CSV
   of ragged-10k's seed-0 data through load_csv, native parser and numpy
   path (both timed; the arrays equal from_numpy_ragged's), then 50
   sweeps of config 4's bucket-route Newton on the loaded data (launches
   asserted, R-hat printed);
9. the user-model toolkit and the data layer's converters (data.py's
   from_ragged / to_ragged / pad_groups_to, model.py's vmap_chains,
   distributions.py, transforms.py), on the card: (a) config 4's seed-0
   data split into per-group lists: RaggedData.from_ragged and
   NestedData.from_ragged(max_obs=30).to_ragged() give from_numpy_ragged's
   arrays exactly (host ms printed), and at one position of 1024 chains
   the loglik kernel on the padded form and the seg_loglik kernel on the
   ragged form agree within |a-b| <= 2e-5 + 2e-5 |b|; the judged data
   through pad_groups_to(1024): loglik, logp_grad and logp_grad_hess on
   the 1000 real groups against the unpadded kernels (bitwise printed,
   1e-3 + 1e-4 |ref| asserted), exactly 0 on the 24 padded groups, one
   newton_step refresh without a NaN; config 3's seed-0 data as ys[g][s]
   lists through NestedData3.from_ragged: from_numpy3's arrays and the
   same pois_loglik bits; unequal subjects per group build members; (b)
   a user's hierarchical logistic written for one chain with the port's
   distributions and log transform (make_hier_logistic's priors), lifted
   by vmap_chains, at config 2's width (64 chains, MALA through autograd
   under vmap, 600/1200): no kernel launch, the posterior means of mu
   and tau within 5 combined MCSEs of phase 6's built-in RW run on the
   same data, its R-hat and ms a sweep printed; (c) config 2 (frozen
   Newton, the R-hat fold in the step kernel; 150/200) and config 4's
   segment route (MALA on the segment kernels; 80/100) each run twice at
   seed 0 and once at seed 1: their launches asserted, every collected
   draw and streamed R-hat bitwise equal between the seed-0 runs, mu
   moved by the other seed; the plain segment sum at config 4's shape
   repeats its bits over 10 calls (the float index_add_ it replaced is
   timed and its distinct results counted beside it); (d) simulation-based
   calibration
   (tests/test_sbc.py's sizes: 512 replicas as chains, each with its own
   data, G=4, N=3, 127 draws thinned by 4) on a jax-free copy of the
   calibration model: rank chi-square p > 1e-3 for mu, log tau and
   theta[0], and the posterior sd of theta[0] below 0.6x the prior's.

Bound: the least time the card could take for a call, the larger of its
bytes (each input read once, each output written once) over 3.35 TB/s and
its float32 operations over 67 TFLOP/s (the H100 SXM data sheet), with
each operation counted once (exp and log1p as one each, so the operation
count is a floor). The Poisson terms take one exp and no log1p or
division, and the Poisson steps read a per-unit prior mean (C, S, p)
where the logistic ones read mu (C, p). The segment kernels count config
4's observations (N, not G x n) and read the (G+1) row pointer. No single
PyTorch call computes any of these functions, so library_ms is null.

Any failed check exits non-zero. The last lines are a JSON object of the
kernels, the nvidia-smi line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

T_START = time.perf_counter()
BUDGET_S = 1200.0           # the whole script, build included
HBM_BPS = 3.35e12           # H100 SXM memory rate, bytes/s
FP32_OPS = 67e12            # H100 SXM float32 rate outside the tensor cores
JUDGED = (1024, 1000, 50, 4)        # C, G, n, p
M100K = (512, 100_000, 20, 3)
RW = (64, 100, 50, 4)                # config 2 (both its presets)
HL1K = (256, 1000, 50, 4)           # hier-logistic-1k (and -mala)
POIS = (512, 4000, 10, 3)           # C, S (subjects), n, p: config 3
SLICE = 64                  # chains the plain versions run on at M100K
SRC = {
    "loglik": ("nestmc_torch/csrc/loglik_logistic.cu",
               "nestmc/ops/pallas/loglik_logistic.py:191"),
    "logp_grad": ("nestmc_torch/csrc/loglik_logistic.cu",
                  "nestmc/ops/pallas/loglik_logistic.py:343"),
    "logp_grad_hess": ("nestmc_torch/csrc/loglik_logistic.cu",
                       "nestmc/ops/pallas/loglik_logistic.py:289"),
    "newton_step_refresh": ("nestmc_torch/csrc/newton_accept.cu",
                            "nestmc/ops/pallas/newton_accept.py:392"),
    "newton_step_frozen": ("nestmc_torch/csrc/newton_accept.cu",
                           "nestmc/ops/pallas/newton_accept.py:392"),
    "mala_step": ("nestmc_torch/csrc/mala_accept.cu",
                  "nestmc/ops/pallas/mala_accept.py:275"),
    "rwmh_step": ("nestmc_torch/csrc/mh_accept.cu",
                  "nestmc/ops/pallas/mh_accept.py:168"),
    "pois_loglik": ("nestmc_torch/csrc/loglik_poisson.cu",
                    "nestmc/ops/pallas/loglik_poisson.py:54"),
    "pois_logp_grad": ("nestmc_torch/csrc/loglik_poisson.cu",
                       "nestmc/ops/pallas/loglik_poisson.py:200"),
    "pois_logp_grad_hess": ("nestmc_torch/csrc/loglik_poisson.cu",
                            "nestmc/ops/pallas/loglik_poisson.py:147"),
    "pois_rwmh_step": ("nestmc_torch/csrc/poisson_accept.cu",
                       "nestmc/ops/pallas/poisson_accept.py:180"),
    "pois_mala_step": ("nestmc_torch/csrc/poisson_accept.cu",
                       "nestmc/ops/pallas/poisson_accept.py:341"),
    "pois_newton_step_refresh": ("nestmc_torch/csrc/poisson_accept.cu",
                                 "nestmc/ops/pallas/poisson_accept.py:576"),
    "pois_newton_step_frozen": ("nestmc_torch/csrc/poisson_accept.cu",
                                "nestmc/ops/pallas/poisson_accept.py:576"),
    "seg_loglik": ("nestmc_torch/csrc/loglik_segment.cu",
                   "nestmc/ops/pallas/loglik_segment.py:244"),
    "seg_logp_grad": ("nestmc_torch/csrc/loglik_segment.cu",
                      "nestmc/ops/pallas/loglik_segment.py:244"),
}


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def left_s() -> float:
    return BUDGET_S - (time.perf_counter() - T_START)


def work(kernel: str, C: int, G: int, n: int, p: int, noise: bool = True,
         fold: bool = False):
    """(bytes, float32 operations) one call needs: each input read and
    each output written once; per obs-cell 2p (eta) + 9 (logistic value
    terms: exp, log1p, ...) or 5 (Poisson: one exp) [+ 2p + 8 or 2p + 2
    (gradient terms)] [+ 3T (Hessian; +1 for the Poisson mask)]
    operations, per cell the step's own algebra. ``kernel`` names a
    LAUNCHES key; G counts the units (groups, or subjects for pois_*).
    For the segment kernels (seg_*) ``n`` is the total number of
    observations N: they read x (N, p), y (N,) and the (G+1) row pointer,
    and evaluate C x N obs-cells."""
    if kernel.startswith("seg_"):
        val_ops = 2 * p + 9
        data = 4 * n * (p + 1) + 4 * (G + 1)
        if kernel == "seg_loglik":
            return data + 4 * C * G * (p + 1), C * n * val_ops
        return (data + 4 * C * G * (2 * p + 1),
                C * n * (val_ops + 2 * p + 8))
    pois = kernel.startswith("pois_")
    kernel = kernel[len("pois_"):] if pois else kernel
    T = p * (p + 1) // 2
    cells, obs = C * G, C * G * n
    data = 4 * G * n * (p + 2) + (4 * G if pois else 0)
    # the prior mean and log tau: mu and log tau (C, p), or per unit
    hyper = 4 * C * p + (4 * cells * p if pois else 4 * C * p)
    f = 4 * 2 * G * p * C if fold else 0          # one (2, G, p, C) array
    nz = 4 * cells * (p + 1) if noise else 0
    val_ops = 2 * p + (5 if pois else 9)
    grad_ops = val_ops + 2 * p + (2 if pois else 8)
    hess_ops = 3 * T + (1 if pois else 0)
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
    frozen = kernel == "newton_step_frozen"
    h = 0 if frozen else 4 * cells * T
    return (data + hyper + nz + 4 * f + 4 * cells * (4 * p + 4 + T) + h,
            obs * (grad_ops + (0 if frozen else hess_ops))
            + cells * (4 * p ** 3 + 30 * p + (8 * p if fold else 0)))


def eight_schools_quadrature() -> dict:
    """Posterior moments of the eight-schools model (mu ~ N(0, 10^2), tau ~
    HalfCauchy(5)) by dense float64 grid quadrature over (mu, log tau),
    theta integrated out in closed form; the grid and formulas of the
    reference's test (tests/test_eight_schools.py)."""
    import numpy as np

    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
    MU, LT = np.meshgrid(np.linspace(-25.0, 40.0, 800),
                         np.linspace(-7.0, 4.5, 800), indexing="ij")
    TAU = np.exp(LT)
    var = sigma[None, None, :] ** 2 + TAU[..., None] ** 2
    loglik = -0.5 * np.sum((y - MU[..., None]) ** 2 / var
                           + np.log(2 * np.pi * var), axis=-1)
    logpost = (loglik - 0.5 * (MU / 10.0) ** 2 - np.log1p((TAU / 5.0) ** 2)
               + LT)
    w = np.exp(logpost - logpost.max())
    w /= w.sum()
    mu_mean = np.sum(w * MU)
    a, b = 1.0 / sigma**2, 1.0 / TAU[..., None] ** 2
    theta_cond = (a * y + b * MU[..., None]) / (a + b)
    return {"mu_mean": mu_mean, "mu_var": np.sum(w * (MU - mu_mean) ** 2),
            "tau_mean": np.sum(w * TAU),
            "theta_mean": np.sum(w[..., None] * theta_cond, axis=(0, 1))}


def calibration_model(G: int, n: int):
    """A jax-free copy of tests/calibration_model.py's chain-batched model
    (the random-walk interweaving form of its twin in
    tests/test_torch_calibration.py, which imports jax): y_gi ~
    N(theta_g, 1), theta_g ~ N(mu, tau), mu ~ N(0, 2), tau ~
    HalfNormal(1.5) as log tau; RW-MH on theta (G units), mu and log_tau
    and the interweaving move on (tau, theta) with z = (theta - mu)/tau
    fixed. Data {"y": (C, G, n)}: one data set a chain (phase 9d's SBC)."""
    import torch

    from nestmc_torch.distributions import logpdf_halfnormal, logpdf_normal
    from nestmc_torch.kernels.rwmh import accept_prob
    from nestmc_torch.model import Block, ModelSpec

    s0, tau0 = 2.0, 1.5

    def lik(state, data):
        return torch.sum(logpdf_normal(data["y"], state["theta"][:, :, None],
                                       1.0), dim=-1)            # (C, G)

    def gprior(state):
        tau = torch.exp(state["log_tau"])[:, None]
        return logpdf_normal(state["theta"], state["mu"][:, None], tau)

    def tau_prior(lt):
        return logpdf_halfnormal(torch.exp(lt), tau0) + lt

    def cond(name, value, state, data):
        state = {**state, name: value}
        if name == "theta":
            return lik(state, data) + gprior(state)
        if name == "mu":
            return (torch.sum(gprior(state), dim=-1)
                    + logpdf_normal(state["mu"], 0.0, s0))
        return torch.sum(gprior(state), dim=-1) + tau_prior(state["log_tau"])

    def joint(state, data):
        return (torch.sum(lik(state, data) + gprior(state), dim=-1)
                + logpdf_normal(state["mu"], 0.0, s0)
                + tau_prior(state["log_tau"]))

    def prior_sample(rng, data, chains):
        mu = s0 * rng.normal((chains,))
        tau = tau0 * torch.abs(rng.normal((chains,)))
        theta = mu[:, None] + tau[:, None] * rng.normal((chains, G))
        return {"theta": theta, "mu": mu, "log_tau": torch.log(tau)}

    def asis_tau_move(rng, position, cache, scale, data):
        theta, mu, lt = position["theta"], position["mu"], position["log_tau"]
        lt_new = lt + scale[:, 0] * rng.normal(lt.shape)
        theta_new = mu[:, None] + (theta - mu[:, None]) * torch.exp(
            lt_new - lt)[:, None]
        log_alpha = (
            torch.sum(lik({**position, "theta": theta_new}, data)
                      - lik(position, data), dim=-1)
            + tau_prior(lt_new) - tau_prior(lt))
        accept = rng.log_uniform(lt.shape) < log_alpha
        return ({"theta": torch.where(accept[:, None], theta_new, theta),
                 "log_tau": torch.where(accept, lt_new, lt)}, {},
                accept_prob(log_alpha))

    def sample_y(rng, theta):
        return theta[:, :, None] + rng.normal(tuple(theta.shape) + (n,))

    return ModelSpec(
        name="calibration_hier_normal",
        blocks=(Block("theta", (G,), units=G, init_scale=0.5),
                Block("mu", (), init_scale=0.5),
                Block("log_tau", (), init_scale=0.3)),
        init_state=prior_sample, cond_logdensity=cond,
        joint_logdensity=joint, prior_sample=prior_sample,
        joint_moves={"asis_tau": asis_tau_move},
        joint_move_init_scale={"asis_tau": 0.1},
    ), sample_y


def bound(nbytes: float, ops: float):
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this smoke test needs a GPU",
              file=sys.stderr)
        return 1

    # fails outside a checkout of the repo
    from nestmc_torch import KernelConfig, RunConfig, SamplerConfig, sample
    from nestmc_torch import bench
    from nestmc_torch.diagnostics import diagnose, ess, fold_rhat_scalars
    from nestmc_torch.models import (
        analytic_hier_normal_posterior,
        make_hier_logistic,
        make_hier_normal_known_scales,
        make_nested_poisson,
        synth_hier_normal,
        synth_logistic,
        synth_poisson3,
    )
    from nestmc_torch.ops import bucket, loglik
    from nestmc_torch.ops.cuda import _build, launch_counts, reset_launch_counts
    from nestmc_torch.ops.cuda import loglik_poisson as pois
    from nestmc_torch.ops.cuda import poisson_accept as pacc
    from nestmc_torch.ops.cuda.loglik_logistic import (
        logistic_loglik,
        logistic_logp_grad,
        logistic_logp_grad_hess,
    )
    from nestmc_torch.ops.cuda.mala_accept import (
        fused_mala_logistic_step,
        fused_mala_logistic_step_plain,
    )
    from nestmc_torch.ops.cuda.mh_accept import (
        fused_rwmh_logistic_step,
        fused_rwmh_logistic_step_plain,
    )
    from nestmc_torch.ops.cuda.loglik_segment import (
        logistic_logp_grad_segment,
        logistic_logp_grad_segment_plain,
        logistic_loglik_segment,
        logistic_loglik_segment_plain,
    )
    from nestmc_torch.ops.cuda.newton_accept import (
        fused_newton_logistic_step,
        fused_newton_logistic_step_plain,
        philox_probe,
    )
    from nestmc_torch.ops.cuda.common import SEG_OBS, TILE_KINDS, tile_plan
    from nestmc_torch.ops.segment import SegmentLayout
    from nestmc_torch.presets import get_preset
    from nestmc_torch.rng import SweepRNG

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----
    smi = bench.gpu_query()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"card: nvidia-smi '{smi}'; torch '{kind}'; "
        f"device_count {count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---- 2. build, p=4 and p=3 at once ----
    t0 = time.perf_counter()
    _build.build([4, 3])
    say(f"build: p=4 and p=3 in {time.perf_counter() - t0:.1f} s")
    for p in (4, 3):
        info = _build.build_info.get(p, {})
        say(f"  p={p}: "
            f"{'%.1f s' % info['seconds'] if info else 'cached'} -> "
            f"{_build.library_path(p).name}")
        for ln in info.get("log", "").splitlines():
            if "registers" in ln or "spill" in ln:
                say(f"    ptxas: {ln.strip()}")

    def timed(fn, batches=7, per=10):
        """ms per call: the median over batches of the mean of `per`
        back-to-back calls between two CUDA events, after warm-up (the
        wrapper's host work then overlaps the previous launch)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(batches):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(per):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / per)
        times.sort()
        return times[len(times) // 2]

    def timed_plain(fn, fn_slice):
        """The plain version's ms at full width, or on the chain slice if
        full width runs out of memory (then said)."""
        try:
            return timed(fn), ""
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            return timed(fn_slice), f" (on {SLICE} chains: full width OOM)"

    def max_err(a, b, rtol):
        """max |a-b| and whether |a-b| <= 1e-3 + rtol |b| everywhere."""
        d = (a - b).abs()
        if d.numel() == 0:
            return 0.0, True
        return float(d.max()), bool((d <= 1e-3 + rtol * b.abs()).all())

    kernels = {}
    launches_total = {}

    def record(name, err, ms=None, plain_ms=None, shape=None, w=None):
        k = kernels.setdefault(name, {"max_abs_err": 0.0})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if ms is not None:
            b_ms, by = bound(*w)
            k.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                     shape=shape)

    def cell(name, shape, err, ms, pms, w, plain_on, **extra):
        """A timed record of ``name`` at another shape than its main one."""
        record(name, err)
        b_ms, by = bound(*w)
        kernels[name].setdefault("cells", []).append({
            "shape_C_G_n_p": list(shape), "ms": ms, "plain_ms": pms,
            "plain_on": plain_on, "bound_ms": b_ms, "bound_by": by,
            "max_abs_err": err, **extra})

    def bound_str(w):
        b_ms, by = bound(*w)
        return (f"bound {b_ms:.4f} ms by {by} ({w[0] / 1e6:.1f} MB, "
                f"{w[1] / 1e9:.2f} G ops)")

    def step_check(out, ref, beta, logu, alpha_i, tol_alpha=2e-3):
        """(max err, ok, differing decisions, outside the 1e-3 band)."""
        acc_k = (out[0] != beta).any(-1)
        acc_p = (ref[0] != beta).any(-1)
        near = (torch.log(ref[alpha_i]) - logu).abs() < 1e-3
        differ = acc_k != acc_p
        n_bad = int((differ & ~near).sum())
        same = ~differ
        errs = []
        for i in range(len(out)):
            a, b = out[i], ref[i]
            if i <= alpha_i:
                m = same if a.dim() == 2 else same[..., None]
                a, b = a[m.expand_as(a)], b[m.expand_as(b)]
            errs.append(max_err(a, b, tol_alpha if i == alpha_i else 1e-4))
        err = max(e for e, _ in errs)
        return err, all(o for _, o in errs) and n_bad == 0, \
            int(differ.sum()), n_bad

    def inputs(shape, data_seed, seed):
        C_, G_, N_, P_ = shape
        data, _ = synth_logistic(data_seed, G=G_, n=N_, p=P_, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        r = {
            "beta": 0.5 * torch.randn(C_, G_, P_, generator=gen, device=dev),
            "mu": 0.3 * torch.randn(C_, P_, generator=gen, device=dev),
            "lt": -0.7 + 0.2 * torch.randn(C_, P_, generator=gen,
                                           device=dev),
            "eps": torch.randn(C_, G_, P_, generator=gen, device=dev),
            "logu": torch.log(torch.rand(C_, G_, generator=gen, device=dev)
                              .clamp_min(1e-38)),
            "gen": gen,
        }
        masked_m = data.mask.clone()
        masked_m[:, N_ - 7:] = 0.0
        r["datasets"] = {"dense": (data.x, data.y, data.mask),
                         "masked": (data.x, data.y * masked_m, masked_m)}
        return r

    # ---- 3. config 3's Poisson kernels at its shape ----
    C, S, N, P = POIS
    pdata, _ = synth_poisson3(3003, G=S // 4, subjects_per_group=4, n=N,
                              p=P, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    beta = 0.3 * torch.randn(C, S, P, generator=gen, device=dev)
    bgs = beta + 0.15 * torch.randn(C, S, P, generator=gen, device=dev)
    lts = -1.4 + 0.2 * torch.randn(C, P, generator=gen, device=dev)
    eps = torch.randn(C, S, P, generator=gen, device=dev)
    logu = torch.log(torch.rand(C, S, generator=gen, device=dev)
                     .clamp_min(1e-38))
    noise = (eps, logu)
    masked_m = pdata.mask.clone()
    masked_m[:, N - 3:] = 0.0
    pdatasets = {"dense": (pdata.x, pdata.y, pdata.mask),
                 "masked": (pdata.x, pdata.y * masked_m, masked_m)}
    for dname, (x, y, m) in pdatasets.items():
        const = loglik.poisson_const(y, m)
        for name, kern, plain in (
            ("pois_loglik", lambda *a: (pois.poisson_loglik(*a),),
             lambda *a: (loglik.poisson_loglik_padded(*a),)),
            ("pois_logp_grad", pois.poisson_logp_grad,
             loglik.poisson_logp_grad_padded),
            ("pois_logp_grad_hess", pois.poisson_logp_grad_hess,
             loglik.poisson_logp_grad_hess_padded),
        ):
            args = (beta, x, y, m, const)
            out, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            errs = [max_err(a, b, 1e-4) for a, b in zip(out, ref)]
            err = max(e for e, _ in errs)
            ok = all(o for _, o in errs)
            ms = timed(lambda: kern(*args))
            pms = timed(lambda: plain(*args))
            w = work(name, C, S, N, P)
            say(f"kernel {name} [{dname}, C={C} S={S} n={N} p={P}]: "
                f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms; {bound_str(w)}")
            if not ok:
                fail(f"{name} [{dname}] disagrees with its plain version")
            record(name, err, ms if dname == "dense" else None, pms, POIS, w)
            del out, ref
        v, g, h = loglik.poisson_logp_grad_hess_padded(beta, x, y, m, const)
        for name, step, plain, args, kw, alpha_i in (
            ("pois_rwmh_step", pacc.fused_rwmh_poisson_step,
             pacc.fused_rwmh_poisson_step_plain,
             (beta, v, torch.full((C, S), -1.2, device=dev), bgs, lts, x, y,
              m), {}, 2),
            ("pois_mala_step", pacc.fused_mala_poisson_step,
             pacc.fused_mala_poisson_step_plain,
             (beta, v, g, torch.full((C, S), -1.0, device=dev), bgs, lts, x,
              y, m), {}, 3),
            ("pois_newton_step_refresh", pacc.fused_newton_poisson_step,
             pacc.fused_newton_poisson_step_plain,
             (beta, v, g, h, torch.zeros(C, S, device=dev), bgs, lts, x, y,
              m), {"frozen": False}, 4),
            ("pois_newton_step_frozen", pacc.fused_newton_poisson_step,
             pacc.fused_newton_poisson_step_plain,
             (beta, v, g, h, torch.zeros(C, S, device=dev), bgs, lts, x, y,
              m), {"frozen": True}, 4),
        ):
            out = step(*args, noise=noise, const=const, **kw)
            ref = plain(*args, noise, const=const, **kw)
            torch.cuda.synchronize()
            if kw.get("frozen"):
                if out[3] is not h:
                    fail("frozen pois_newton_step must return h itself")
                out, ref, alpha_i = out[:3] + out[4:], ref[:3] + ref[4:], 3
            err, ok, n_diff, n_bad = step_check(out, ref, beta, logu,
                                                alpha_i)
            acc = float(ref[alpha_i].mean())
            ms = timed(lambda: step(*args, noise=noise, const=const, **kw))
            pms = timed(lambda: plain(*args, noise, const=const, **kw))
            w = work(name, C, S, N, P)
            say(f"kernel {name} [{dname}, C={C} S={S} n={N} p={P}]: "
                f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|, alpha "
                f"2e-3|ref|); mean alpha {acc:.3f}; accept decisions differ "
                f"in {n_diff} of {C * S} cells, {n_bad} outside "
                f"|log a - log u| < 1e-3 {'ok' if ok else 'FAIL'}; kernel "
                f"{ms:.4f} ms, plain {pms:.4f} ms; {bound_str(w)}")
            if not ok:
                fail(f"{name} [{dname}] disagrees with its plain version")
            record(name, err, ms if dname == "dense" else None, pms, POIS, w)
            del out, ref
        del v, g, h
    del pdata, pdatasets, beta, bgs, lts, eps, logu, noise, masked_m
    torch.cuda.empty_cache()

    # ---- 3a. the Newton path's kernels at the judged shape ----
    C, G, N, P = JUDGED
    d = inputs(JUDGED, 2000, 7)
    beta, mu, lt, eps, logu = (d[k] for k in ("beta", "mu", "lt", "eps",
                                              "logu"))
    ls = torch.zeros(C, G, device=dev)
    for name, kern, plain in (
        ("logp_grad", logistic_logp_grad, loglik.logistic_logp_grad_padded),
        ("logp_grad_hess", logistic_logp_grad_hess,
         loglik.logistic_logp_grad_hess_padded),
    ):
        for dname, (x, y, m) in d["datasets"].items():
            out, ref = kern(beta, x, y, m), plain(beta, x, y, m)
            torch.cuda.synchronize()
            errs = [max_err(a, b, 1e-4) for a, b in zip(out, ref)]
            err = max(e for e, _ in errs)
            ok = all(o for _, o in errs)
            ms = timed(lambda: kern(beta, x, y, m))
            pms = timed(lambda: plain(beta, x, y, m))
            w = work(name, C, G, N, P)
            say(f"kernel {name} [{dname}, C={C} G={G} n={N} p={P}]: "
                f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms; {bound_str(w)}")
            if not ok:
                fail(f"{name} [{dname}] disagrees with its plain version")
            main = dname == "dense"
            record(name, err, ms if main else None, pms, JUDGED, w)

    for frozen in (False, True):
        for fold in (False, True):
            for dname, (x, y, m) in d["datasets"].items():
                v, g, h = loglik.logistic_logp_grad_hess_padded(beta, x, y, m)
                rf = None
                if fold:
                    rf = (torch.randn(2, G, P, C, generator=d["gen"],
                                      device=dev),
                          torch.rand(2, G, P, C, generator=d["gen"],
                                     device=dev),
                          fold_rhat_scalars([11.0, 0.0], 11, 2048))
                args = (beta, v, g, h, ls, mu, lt, x, y, m)
                out = fused_newton_logistic_step(
                    *args, noise=(eps, logu), frozen=frozen, rhat_fold=rf)
                ref = fused_newton_logistic_step_plain(
                    *args, (eps, logu), frozen=frozen, rhat_fold=rf)
                torch.cuda.synchronize()
                if frozen and out[3] is not h:
                    fail("frozen newton_step must return h itself")
                keep = [i for i in range(len(out)) if not (frozen and i == 3)]
                err, ok, n_diff, n_bad = step_check(
                    [out[i] for i in keep], [ref[i] for i in keep], beta,
                    logu, keep.index(4))
                ms = timed(lambda: fused_newton_logistic_step(
                    *args, noise=(eps, logu), frozen=frozen, rhat_fold=rf))
                pms = timed(lambda: fused_newton_logistic_step_plain(
                    *args, (eps, logu), frozen=frozen, rhat_fold=rf))
                kname = ("newton_step_frozen" if frozen
                         else "newton_step_refresh")
                w = work(kname, C, G, N, P, fold=fold)
                case = (f"{'frozen' if frozen else 'refresh'}"
                        f"{'+fold' if fold else ''} [{dname}]")
                say(f"kernel newton_step {case}: max_abs_err {err:.3e} "
                    f"(tol 1e-3 + 1e-4|ref|, alpha 2e-3|ref|); accept "
                    f"decisions differ in {n_diff} cells, {n_bad} outside "
                    f"|log a - log u| < 1e-3 {'ok' if ok else 'FAIL'}; "
                    f"kernel {ms:.4f} ms, plain {pms:.4f} ms; "
                    f"{bound_str(w)}")
                if not ok:
                    fail(f"newton_step {case} disagrees with its plain "
                         "version")
                # the main path's cases: refresh without fold (warmup) and
                # frozen with fold (sampling), on the dense judged data
                main = dname == "dense" and fold == frozen
                record(kname, err, ms if main else None, pms, JUDGED, w)
                del out, ref
    del d, beta, mu, lt, eps, logu, ls, v, g, h, rf, args
    torch.cuda.empty_cache()

    # ---- 3b. the MALA path's kernels at the mala-100k shape ----
    C, G, N, P = M100K
    S = SLICE
    d = inputs(M100K, 5000, 8)
    beta, mu, lt, eps, logu = (d[k] for k in ("beta", "mu", "lt", "eps",
                                              "logu"))
    ls = torch.full((C, G), -1.3, device=dev)
    sl = (beta[:S], mu[:S], lt[:S], eps[:S], logu[:S], ls[:S])
    for dname, (x, y, m) in d["datasets"].items():
        out = logistic_logp_grad(beta, x, y, m)
        ref = loglik.logistic_logp_grad_padded(beta[:S], x, y, m)
        torch.cuda.synchronize()
        errs = [max_err(a[:S], b, 1e-4) for a, b in zip(out, ref)]
        err = max(e for e, _ in errs)
        ok = all(o for _, o in errs)
        ms = timed(lambda: logistic_logp_grad(beta, x, y, m))
        pms, note = timed_plain(
            lambda: loglik.logistic_logp_grad_padded(beta, x, y, m),
            lambda: loglik.logistic_logp_grad_padded(beta[:S], x, y, m))
        say(f"kernel logp_grad [{dname}, C={C} G={G} n={N} p={P}, parity on "
            f"{S} chains]: max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms{note}; {bound_str(work('logp_grad', *M100K))}")
        if not ok:
            fail(f"logp_grad [{dname}] at the mala-100k shape disagrees")
        record("logp_grad", err)
        del out, ref
        v, g = logistic_logp_grad(beta, x, y, m)
        for fold in (False, True):
            rf = rf_s = None
            if fold:
                fmean = torch.randn(2, G, P, C, generator=d["gen"],
                                    device=dev)
                fm2 = torch.rand(2, G, P, C, generator=d["gen"], device=dev)
                sc = fold_rhat_scalars([11.0, 0.0], 11, 512)
                rf, rf_s = (fmean, fm2, sc), (fmean[..., :S], fm2[..., :S],
                                              sc)
            args = (beta, v, g, ls, mu, lt, x, y, m)
            out = fused_mala_logistic_step(*args, noise=(eps, logu),
                                           rhat_fold=rf)
            ref = fused_mala_logistic_step_plain(
                sl[0], v[:S], g[:S], sl[5], sl[1], sl[2], x, y, m,
                (sl[3], sl[4]), rhat_fold=rf_s)
            torch.cuda.synchronize()
            out_s = [o[:S] for o in out[:4]] + [o[..., :S] for o in out[4:]]
            err, ok, n_diff, n_bad = step_check(out_s, ref, sl[0], sl[4], 3)
            ms = timed(lambda: fused_mala_logistic_step(
                *args, noise=(eps, logu), rhat_fold=rf))
            pms, note = timed_plain(
                lambda: fused_mala_logistic_step_plain(
                    *args, (eps, logu), rhat_fold=rf),
                lambda: fused_mala_logistic_step_plain(
                    sl[0], v[:S], g[:S], sl[5], sl[1], sl[2], x, y, m,
                    (sl[3], sl[4]), rhat_fold=rf_s))
            w = work("mala_step", C, G, N, P, fold=fold)
            case = f"{'fold' if fold else 'no fold'} [{dname}]"
            say(f"kernel mala_step {case}, C={C} G={G} n={N} p={P}, parity "
                f"on {S} chains: max_abs_err {err:.3e} (tol 1e-3 + "
                f"1e-4|ref|, alpha 2e-3|ref|); accept decisions differ in "
                f"{n_diff} of {S * G} cells, {n_bad} outside |log a - log u|"
                f" < 1e-3 {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms "
                f"(external noise), plain {pms:.4f} ms{note}; {bound_str(w)}")
            if not ok:
                fail(f"mala_step {case} disagrees with its plain version")
            # the main path's case: no fold (thin 4), dense data, Philox
            # noise drawn in the kernel: its record times that mode
            main = dname == "dense" and not fold
            record("mala_step", err)
            if main:
                key = SweepRNG(8, dev)
                ms_px = timed(lambda: fused_mala_logistic_step(*args,
                                                               rng=key))
                w_px = work("mala_step", C, G, N, P, noise=False)
                say(f"kernel mala_step [main path's mode: Philox noise, no "
                    f"fold, {dname}, C={C} G={G} n={N} p={P}]: kernel "
                    f"{ms_px:.4f} ms (external noise {ms:.4f} ms); "
                    f"{bound_str(w_px)}")
                record("mala_step", err, ms_px, pms, M100K, w_px)
                kernels["mala_step"]["ms_external_noise"] = ms
            del out, ref, out_s, rf, rf_s
            torch.cuda.empty_cache()
        del v, g

    # rwmh_step and loglik at the mala-100k shape, then at the RW preset's
    for shape in (M100K, RW):
        C, G, N, P = shape
        S = min(SLICE, C)
        if shape == RW:
            del d, beta, mu, lt, eps, logu, ls, sl
            torch.cuda.empty_cache()
            d = inputs(RW, 1000, 9)
            beta, mu, lt, eps, logu = (d[k] for k in ("beta", "mu", "lt",
                                                      "eps", "logu"))
        ls = torch.full((C, G), -1.6, device=dev)
        sl = (beta[:S], mu[:S], lt[:S], eps[:S], logu[:S], ls[:S])
        main = shape == RW
        for dname, (x, y, m) in d["datasets"].items():
            out = logistic_loglik(beta, x, y, m)
            ref = loglik.logistic_loglik_padded(sl[0], x, y, m)
            torch.cuda.synchronize()
            err, ok = max_err(out[:S], ref, 1e-4)
            ms = timed(lambda: logistic_loglik(beta, x, y, m))
            pms, note = timed_plain(
                lambda: loglik.logistic_loglik_padded(beta, x, y, m),
                lambda: loglik.logistic_loglik_padded(sl[0], x, y, m))
            w = work("loglik", C, G, N, P)
            say(f"kernel loglik [{dname}, C={C} G={G} n={N} p={P}, parity on "
                f"{S} chains]: max_abs_err {err:.3e} (tol 1e-3 + "
                f"1e-4|ref|) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms{note}; {bound_str(w)}")
            if not ok:
                fail(f"loglik [{dname}] disagrees with its plain version")
            record("loglik", err, ms if main and dname == "dense" else None,
                   pms, shape, w)
            lik = out
            args = (beta, lik, ls, mu, lt, x, y, m)
            out = fused_rwmh_logistic_step(*args, noise=(eps, logu))
            ref = fused_rwmh_logistic_step_plain(
                sl[0], lik[:S], sl[5], sl[1], sl[2], x, y, m, (sl[3], sl[4]))
            torch.cuda.synchronize()
            err, ok, n_diff, n_bad = step_check(
                [o[:S] for o in out], ref, sl[0], sl[4], 2)
            ms = timed(lambda: fused_rwmh_logistic_step(
                *args, noise=(eps, logu)))
            pms, note = timed_plain(
                lambda: fused_rwmh_logistic_step_plain(*args, (eps, logu)),
                lambda: fused_rwmh_logistic_step_plain(
                    sl[0], lik[:S], sl[5], sl[1], sl[2], x, y, m,
                    (sl[3], sl[4])))
            w = work("rwmh_step", C, G, N, P)
            say(f"kernel rwmh_step [{dname}, C={C} G={G} n={N} p={P}, parity "
                f"on {S} chains]: max_abs_err {err:.3e} (tol 1e-3 + "
                f"1e-4|ref|, alpha 2e-3|ref|); accept decisions differ in "
                f"{n_diff} of {S * G} cells, {n_bad} outside |log a - log u|"
                f" < 1e-3 {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms{note}; {bound_str(w)}")
            if not ok:
                fail(f"rwmh_step [{dname}] disagrees with its plain version")
            record("rwmh_step", err, ms if main and dname == "dense" else None,
                   pms, shape, w)
            del out, ref, lik, args
    del d, beta, mu, lt, eps, logu, ls, sl
    torch.cuda.empty_cache()

    # ---- 3c. config 4: the segment kernels and the bucketed route ----
    _, rdata, _ = get_preset("ragged-10k", device=dev)     # seed 0's data
    C, G, P = 1024, rdata.num_groups, rdata.num_covariates
    NOBS = rdata.num_obs
    sizes = rdata.sizes()
    seg_layout = SegmentLayout.build(rdata.segment_ids, G)
    blayout = bucket.BucketLayout.build(rdata.segment_ids, G, x=rdata.x,
                                        y=rdata.y)
    B = len(blayout.buckets)
    say(f"config 4 data: G={G} N={NOBS} p={P}, group sizes "
        f"{int(sizes.min())}..{int(sizes.max())}; {B} size buckets (cap, "
        f"groups) {[(b.cap, len(b.obs_index)) for b in blayout.buckets]}, "
        f"{blayout.padded_obs()} padded obs")
    gen = torch.Generator(device=dev).manual_seed(10)
    beta = 0.5 * torch.randn(C, G, P, generator=gen, device=dev)

    def seg_err(out, ref, rtols):
        """max |a-b| and whether |a-b| <= 2e-5 + rtol |b| everywhere."""
        errs = [((a - b).abs(), rtol * b.abs()) for a, b, rtol
                in zip(out, ref, rtols)]
        return (max(float(d.max()) for d, _ in errs),
                all(bool((d <= 2e-5 + r).all()) for d, r in errs))

    small_sizes = torch.tensor([0, 5, 12, 700, 0, 257, 256, 1] * 4 + [0, 3])
    gs = torch.Generator().manual_seed(11)
    s_seg = torch.repeat_interleave(torch.arange(small_sizes.numel()),
                                    small_sizes)
    small = (0.7 * torch.randn(130, small_sizes.numel(), P,
                               generator=gs).to(dev),
             torch.randn(s_seg.numel(), P, generator=gs).to(dev),
             (torch.rand(s_seg.numel(), generator=gs) < 0.5).float().to(dev),
             SegmentLayout.build(s_seg, small_sizes.numel(), device=dev))
    for name, kern, plain, rtols in (
        ("seg_loglik", lambda *a: (logistic_loglik_segment(*a),),
         lambda *a: (logistic_loglik_segment_plain(*a),), (2e-5,)),
        ("seg_logp_grad", logistic_logp_grad_segment,
         logistic_logp_grad_segment_plain, (2e-5, 2e-4)),
    ):
        out, ref = kern(*small), plain(*small)
        torch.cuda.synchronize()
        err, ok = seg_err(out, ref, rtols)
        empty = (small_sizes == 0).to(dev)
        ok &= bool((out[0][:, empty] == 0).all())
        say(f"kernel {name} [small: C=130, G={small_sizes.numel()}, empty "
            f"groups and groups of 256-700 obs]: max_abs_err {err:.3e} "
            f"(tol 2e-5 + {rtols[-1]:g}|ref|, empty groups exactly 0) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} [small] disagrees with its plain version")
        record(name, err)
        args = (beta, rdata.x, rdata.y, seg_layout)
        out, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err, ok = seg_err(out, ref, rtols)
        ms = timed(lambda: kern(*args))
        pms = timed(lambda: plain(*args))
        w = work(name, C, G, NOBS, P)
        say(f"kernel {name} [config 4, C={C} G={G} N={NOBS} p={P}]: "
            f"max_abs_err {err:.3e} (tol 2e-5 + {rtols[-1]:g}|ref|) "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms; {bound_str(w)}")
        if not ok:
            fail(f"{name} at config 4's shape disagrees with its plain "
                 "version")
        record(name, err, ms, pms, (C, G, NOBS, P), w)
        del out, ref
    del small
    torch.cuda.empty_cache()

    # the bucketed route's kernels at the widest bucket's shape
    wb = blayout.buckets[-1]
    Gb, cap = len(wb.obs_index), wb.cap
    x, y, m = wb.x, wb.y, wb.mask
    bb = beta.index_select(1, wb.group_index)
    gb = torch.Generator(device=dev).manual_seed(12)
    mu = 0.3 * torch.randn(C, P, generator=gb, device=dev)
    lt = -0.7 + 0.2 * torch.randn(C, P, generator=gb, device=dev)
    eps = torch.randn(C, Gb, P, generator=gb, device=dev)
    logu = torch.log(torch.rand(C, Gb, generator=gb, device=dev)
                     .clamp_min(1e-38))
    shape = f"C={C} Gb={Gb} cap={cap} p={P}, widest bucket"
    for name, kern, plain in (
        ("logp_grad", logistic_logp_grad, loglik.logistic_logp_grad_padded),
        ("logp_grad_hess", logistic_logp_grad_hess,
         loglik.logistic_logp_grad_hess_padded),
    ):
        out, ref = kern(bb, x, y, m), plain(bb, x, y, m)
        torch.cuda.synchronize()
        errs = [max_err(a, b, 1e-4) for a, b in zip(out, ref)]
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        ms = timed(lambda: kern(bb, x, y, m))
        pms = timed(lambda: plain(bb, x, y, m))
        say(f"kernel {name} [{shape}]: max_abs_err {err:.3e} (tol 1e-3 + "
            f"1e-4|ref|) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms; {bound_str(work(name, C, Gb, cap, P))}")
        if not ok:
            fail(f"{name} at the widest bucket disagrees")
        record(name, err)
    v, g, h = loglik.logistic_logp_grad_hess_padded(bb, x, y, m)
    for kname, step, plain, args, kw, alpha_i in (
        ("newton_step_refresh", fused_newton_logistic_step,
         fused_newton_logistic_step_plain,
         (bb, v, g, h, torch.zeros(C, Gb, device=dev), mu, lt, x, y, m),
         {"frozen": False}, 4),
        ("newton_step_frozen", fused_newton_logistic_step,
         fused_newton_logistic_step_plain,
         (bb, v, g, h, torch.zeros(C, Gb, device=dev), mu, lt, x, y, m),
         {"frozen": True}, 4),
        ("mala_step", fused_mala_logistic_step,
         fused_mala_logistic_step_plain,
         (bb, v, g, torch.full((C, Gb), -1.3, device=dev), mu, lt, x, y, m),
         {}, 3),
    ):
        out = step(*args, noise=(eps, logu), **kw)
        ref = plain(*args, (eps, logu), **kw)
        torch.cuda.synchronize()
        if kw.get("frozen"):
            if out[3] is not h:
                fail("frozen newton_step must return h itself")
            out, ref, alpha_i = out[:3] + out[4:], ref[:3] + ref[4:], 3
        err, ok, n_diff, n_bad = step_check(out, ref, bb, logu, alpha_i)
        ms = timed(lambda: step(*args, noise=(eps, logu), **kw))
        pms = timed(lambda: plain(*args, (eps, logu), **kw))
        say(f"kernel {kname} [{shape}]: max_abs_err {err:.3e} (tol 1e-3 + "
            f"1e-4|ref|, alpha 2e-3|ref|); mean alpha "
            f"{float(ref[alpha_i].mean()):.3f}; accept decisions differ in "
            f"{n_diff} of {C * Gb} cells, {n_bad} outside |log a - log u| "
            f"< 1e-3 {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms; {bound_str(work(kname, C, Gb, cap, P))}")
        if not ok:
            fail(f"{kname} at the widest bucket disagrees with its plain "
                 "version")
        record(kname, err)
        del out, ref
    del beta, bb, x, y, m, v, g, h, mu, lt, eps, logu, blayout, seg_layout
    torch.cuda.empty_cache()

    # ---- 3d. the tiled templates at partial tiles and odd sizes ----
    # (C, G, n): one chain, units below a tile, ragged tiles on both axes,
    # one observation; n = 3000 gives one unit a tile (its rows all masked
    # but every 100th, so the float32 sums stay within the tolerance)
    for P in (3, 4):
        for C, G, N in ((1, 1, 1), (33, 31, 13), (130, 33, 50), (1, 70, 13),
                        (33, 70, 1), (130, 1, 50), (33, 3, 3000)):
            ge = torch.Generator(device=dev).manual_seed(13 + C + G + N)
            x = torch.randn(G, N, P, generator=ge, device=dev)
            x[:, :, 0] = 1.0
            m = torch.ones(G, N, device=dev)
            m[0, max(N - 4, 0):] = 0.0
            if N == 3000:
                m.zero_()
                m[:, ::100] = 1.0
            y = (torch.rand(G, N, generator=ge, device=dev) < 0.5).float() * m
            ypo = torch.poisson(torch.full((G, N), 1.5, device=dev),
                                generator=ge) * m
            const = loglik.poisson_const(ypo, m)
            beta = 0.5 * torch.randn(C, G, P, generator=ge, device=dev)
            bpo = 0.3 * torch.randn(C, G, P, generator=ge, device=dev)
            mu = 0.3 * torch.randn(C, P, generator=ge, device=dev)
            lt = -0.5 + 0.2 * torch.randn(C, P, generator=ge, device=dev)
            eps = torch.randn(C, G, P, generator=ge, device=dev)
            logu = torch.log(torch.rand(C, G, generator=ge, device=dev)
                             .clamp_min(1e-38))
            rf = (torch.randn(2, G, P, C, generator=ge, device=dev),
                  torch.rand(2, G, P, C, generator=ge, device=dev),
                  fold_rhat_scalars([3.0, 0.0], 3, 5))
            errs = {}
            for name, kern, plain, a in (
                ("logp_grad", logistic_logp_grad,
                 loglik.logistic_logp_grad_padded, (beta, x, y, m)),
                ("logp_grad_hess", logistic_logp_grad_hess,
                 loglik.logistic_logp_grad_hess_padded, (beta, x, y, m)),
                ("pois_logp_grad", pois.poisson_logp_grad,
                 loglik.poisson_logp_grad_padded, (bpo, x, ypo, m, const)),
                ("pois_logp_grad_hess", pois.poisson_logp_grad_hess,
                 loglik.poisson_logp_grad_hess_padded,
                 (bpo, x, ypo, m, const)),
            ):
                out, ref = kern(*a), plain(*a)
                torch.cuda.synchronize()
                es = [max_err(o, f, 1e-4) for o, f in zip(out, ref)]
                errs[name] = (max(e for e, _ in es), all(o for _, o in es))
            v, g = loglik.logistic_logp_grad_padded(beta, x, y, m)
            ls = torch.full((C, G), -1.3, device=dev)
            for fold in (None, rf):
                args = (beta, v, g, ls, mu, lt, x, y, m)
                out = fused_mala_logistic_step(*args, noise=(eps, logu),
                                               rhat_fold=fold)
                ref = fused_mala_logistic_step_plain(*args, (eps, logu),
                                                     rhat_fold=fold)
                torch.cuda.synchronize()
                e, o, _, _ = step_check(out, ref, beta, logu, 3)
                prev = errs.get("mala_step", (0.0, True))
                errs["mala_step"] = (max(prev[0], e), prev[1] and o)
            vp, gp = loglik.poisson_logp_grad_padded(bpo, x, ypo, m, const)
            args = (bpo, vp, gp, ls, bpo + 0.1, lt - 0.7, x, ypo, m)
            out = pacc.fused_mala_poisson_step(*args, noise=(eps, logu),
                                               const=const)
            ref = pacc.fused_mala_poisson_step_plain(*args, (eps, logu),
                                                     const=const)
            torch.cuda.synchronize()
            e, o, _, _ = step_check(out, ref, bpo, logu, 3)
            errs["pois_mala_step"] = (e, o)
            # the Newton steps: Logit refresh and frozen, without and with
            # the fold; Poisson refresh and frozen
            lz = torch.zeros(C, G, device=dev)
            hs = (loglik.logistic_logp_grad_hess_padded(beta, x, y, m),
                  loglik.poisson_logp_grad_hess_padded(bpo, x, ypo, m, const))
            for frozen in (False, True):
                kname = ("newton_step_frozen" if frozen
                         else "newton_step_refresh")
                for fold in (None, rf):
                    args = (beta, *hs[0], lz, mu, lt, x, y, m)
                    out = fused_newton_logistic_step(
                        *args, noise=(eps, logu), frozen=frozen,
                        rhat_fold=fold)
                    ref = fused_newton_logistic_step_plain(
                        *args, (eps, logu), frozen=frozen, rhat_fold=fold)
                    torch.cuda.synchronize()
                    if frozen and out[3] is not hs[0][2]:
                        fail("frozen newton_step must return h itself")
                    keep = [i for i in range(len(out))
                            if not (frozen and i == 3)]
                    e, o, _, _ = step_check(
                        [out[i] for i in keep], [ref[i] for i in keep], beta,
                        logu, keep.index(4))
                    prev = errs.get(kname, (0.0, True))
                    errs[kname] = (max(prev[0], e), prev[1] and o)
                args = (bpo, *hs[1], lz, bpo + 0.1, lt - 0.7, x, ypo, m)
                out = pacc.fused_newton_poisson_step(
                    *args, noise=(eps, logu), frozen=frozen, const=const)
                ref = pacc.fused_newton_poisson_step_plain(
                    *args, (eps, logu), frozen=frozen, const=const)
                torch.cuda.synchronize()
                if frozen:
                    if out[3] is not hs[1][2]:
                        fail("frozen pois_newton_step must return h itself")
                    out, ref = out[:3] + out[4:], ref[:3] + ref[4:]
                e, o, _, _ = step_check(out, ref, bpo, logu,
                                        3 if frozen else 4)
                errs["pois_" + kname] = (e, o)
            # the value-only loglik and the RW-MH steps, Logit and Poisson
            for name, kern, plain, a in (
                ("loglik", logistic_loglik, loglik.logistic_loglik_padded,
                 (beta, x, y, m)),
                ("pois_loglik", pois.poisson_loglik,
                 loglik.poisson_loglik_padded, (bpo, x, ypo, m, const)),
            ):
                out, ref = kern(*a), plain(*a)
                torch.cuda.synchronize()
                errs[name] = max_err(out, ref, 1e-4)
            args = (beta, loglik.logistic_loglik_padded(beta, x, y, m), ls,
                    mu, lt, x, y, m)
            out = fused_rwmh_logistic_step(*args, noise=(eps, logu))
            ref = fused_rwmh_logistic_step_plain(*args, (eps, logu))
            torch.cuda.synchronize()
            e, o, _, _ = step_check(out, ref, beta, logu, 2)
            errs["rwmh_step"] = (e, o)
            args = (bpo, loglik.poisson_loglik_padded(bpo, x, ypo, m, const),
                    ls, bpo + 0.1, lt - 0.7, x, ypo, m)
            out = pacc.fused_rwmh_poisson_step(*args, noise=(eps, logu),
                                               const=const)
            ref = pacc.fused_rwmh_poisson_step_plain(*args, (eps, logu),
                                                     const=const)
            torch.cuda.synchronize()
            e, o, _, _ = step_check(out, ref, bpo, logu, 2)
            errs["pois_rwmh_step"] = (e, o)
            tgs = sorted({tile_plan(k, N, P)[0] for k in TILE_KINDS
                          if k != "seg"})
            ok = all(o for _, o in errs.values())
            say(f"tiled kernels [C={C} G={G} n={N} p={P}, units a tile "
                f"{tgs}]: max_abs_err "
                + ", ".join(f"{k} {e:.2e}" for k, (e, _) in errs.items())
                + f" (tol 1e-3 + 1e-4|ref|, alpha 2e-3|ref|) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"a tiled kernel at C={C} G={G} n={N} p={P} disagrees "
                     "with its plain version")
            for k, (e, _) in errs.items():
                record(k, e)
    # the segment kernels' tile (tg groups x 32 chains, observations staged
    # in chunks of tg x SEG_OBS): a group longer than a chunk and tiles
    # over the chunk budget, a group straddling a chunk boundary, config
    # 4's sizes with empty groups at G and C off the tile, fewer groups
    # than a tile, one chain
    for P in (3, 4):
        tg_seg = tile_plan("seg", SEG_OBS, P)[0]
        for C, sizes in ((33, [1500] + [30] * 39), (20, [40] * 33),
                         (70, [0 if i % 17 == 3 else 5 + (7 * i) % 26
                               for i in range(100)]),
                         (1, [3, 0, 31, 1, 2])):
            G = len(sizes)
            ge = torch.Generator(device=dev).manual_seed(17 + C + G)
            sz = torch.tensor(sizes)
            sl_ = SegmentLayout.build(
                torch.repeat_interleave(torch.arange(G), sz), G, device=dev)
            xs_ = torch.randn(int(sz.sum()), P, generator=ge, device=dev)
            ys_ = (torch.rand(int(sz.sum()), generator=ge, device=dev)
                   < 0.5).float()
            bs_ = 0.7 * torch.randn(C, G, P, generator=ge, device=dev)
            errs = {}
            for name, kern, plain, rtols in (
                ("seg_loglik", lambda *a: (logistic_loglik_segment(*a),),
                 lambda *a: (logistic_loglik_segment_plain(*a),), (2e-5,)),
                ("seg_logp_grad", logistic_logp_grad_segment,
                 logistic_logp_grad_segment_plain, (2e-5, 2e-4)),
            ):
                out = kern(bs_, xs_, ys_, sl_)
                ref = plain(bs_, xs_, ys_, sl_)
                torch.cuda.synchronize()
                e, o = seg_err(out, ref, rtols)
                o &= bool((out[0][:, (sz == 0).to(dev)] == 0).all())
                errs[name] = (e, o)
            ok = all(o for _, o in errs.values())
            say(f"tiled segment kernels [C={C} G={G} N={int(sz.sum())} "
                f"p={P}, groups of {min(sizes)}..{max(sizes)} obs, "
                f"{tg_seg} groups a tile, chunks of {tg_seg * SEG_OBS} "
                "obs]: max_abs_err "
                + ", ".join(f"{k} {e:.2e}" for k, (e, _) in errs.items())
                + f" (tol 2e-5 + rtol|ref|, empty groups exactly 0) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"a segment kernel at C={C} G={G} p={P} disagrees "
                     "with its plain version")
            for k, (e, _) in errs.items():
                record(k, e)
    torch.cuda.empty_cache()

    # ---- 3e. the Newton path's kernels at config 2's, the 1k-group
    # presets' and mala-100k-newton's shapes, and MALA at p=4 ----
    for shape, data_seed, seed in ((RW, 1000, 14), (HL1K, 2000, 15),
                                   (M100K, 5000, 16)):
        C, G, N, P = shape
        # the plain versions' (C, G, n) temporaries are 4.1 GB each at
        # mala-100k's width: there they run on the first chains only
        S = C if shape != M100K else SLICE
        plain_on = "full width" if S == C else f"{S} chains"
        d = inputs(shape, data_seed, seed)
        beta, mu, lt, eps, logu = (d[k] for k in ("beta", "mu", "lt", "eps",
                                                  "logu"))
        x, y, m = d["datasets"]["dense"]
        for name, kern, plain in (
            ("logp_grad", logistic_logp_grad,
             loglik.logistic_logp_grad_padded),
            ("logp_grad_hess", logistic_logp_grad_hess,
             loglik.logistic_logp_grad_hess_padded),
        ):
            out, ref = kern(beta, x, y, m), plain(beta[:S], x, y, m)
            torch.cuda.synchronize()
            errs = [max_err(a[:S], b, 1e-4) for a, b in zip(out, ref)]
            err, ok = max(e for e, _ in errs), all(o for _, o in errs)
            ms = timed(lambda: kern(beta, x, y, m))
            pms = timed(lambda: plain(beta[:S], x, y, m))
            w = work(name, C, G, N, P)
            say(f"kernel {name} [C={C} G={G} n={N} p={P}, parity and plain "
                f"on {plain_on}]: max_abs_err {err:.3e} (tol 1e-3 + "
                f"1e-4|ref|) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms; {bound_str(w)}")
            if not ok:
                fail(f"{name} at C={C} G={G} disagrees with its plain version")
            cell(name, shape, err, ms, pms, w, plain_on)
            del out, ref
        v, g, h = logistic_logp_grad_hess(beta, x, y, m)
        ls = torch.zeros(C, G, device=dev)
        sl = tuple(a[:S] for a in (beta, v, g, h, ls, mu, lt))
        # refresh (warmup), frozen (mala-100k-newton's sampling: its R-hat
        # is thinned, so nothing folds in the kernel) and frozen+fold
        # (config 2's and hier-logistic-1k's sampling)
        for frozen, fold in ((False, False), (True, False), (True, True)):
            rf = rf_s = None
            if fold:
                fm = torch.randn(2, G, P, C, generator=d["gen"], device=dev)
                fm2 = torch.rand(2, G, P, C, generator=d["gen"], device=dev)
                sc = fold_rhat_scalars([11.0, 0.0], 11, 2048)
                rf, rf_s = (fm, fm2, sc), (fm[..., :S], fm2[..., :S], sc)
            args = (beta, v, g, h, ls, mu, lt, x, y, m)
            out = fused_newton_logistic_step(*args, noise=(eps, logu),
                                             frozen=frozen, rhat_fold=rf)
            ref = fused_newton_logistic_step_plain(
                *sl, x, y, m, (eps[:S], logu[:S]), frozen=frozen,
                rhat_fold=rf_s)
            torch.cuda.synchronize()
            if frozen and out[3] is not h:
                fail("frozen newton_step must return h itself")
            out_s = [o[:S] for o in out[:5]] + [o[..., :S] for o in out[5:]]
            keep = [i for i in range(len(out_s)) if not (frozen and i == 3)]
            err, ok, n_diff, n_bad = step_check(
                [out_s[i] for i in keep], [ref[i] for i in keep], beta[:S],
                logu[:S], keep.index(4))
            ms_ext = timed(lambda: fused_newton_logistic_step(
                *args, noise=(eps, logu), frozen=frozen, rhat_fold=rf))
            key = SweepRNG(seed, dev)
            ms = timed(lambda: fused_newton_logistic_step(
                *args, rng=key, frozen=frozen, rhat_fold=rf))
            pms = timed(lambda: fused_newton_logistic_step_plain(
                *sl, x, y, m, (eps[:S], logu[:S]), frozen=frozen,
                rhat_fold=rf_s))
            kname = "newton_step_frozen" if frozen else "newton_step_refresh"
            w = work(kname, C, G, N, P, noise=False, fold=fold)
            case = (f"{'frozen' if frozen else 'refresh'}"
                    f"{'+fold' if fold else ''}")
            say(f"kernel newton_step {case} [C={C} G={G} n={N} p={P}, parity "
                f"and plain on {plain_on}]: max_abs_err {err:.3e} (tol 1e-3 "
                f"+ 1e-4|ref|, alpha 2e-3|ref|); accept decisions differ in "
                f"{n_diff} of {S * G} cells, {n_bad} outside |log a - log u| "
                f"< 1e-3 {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms "
                f"(Philox noise; external noise {ms_ext:.4f} ms), plain "
                f"{pms:.4f} ms; {bound_str(w)} (Philox)")
            if not ok:
                fail(f"newton_step {case} at C={C} G={G} disagrees with its "
                     "plain version")
            cell(kname, shape, err, ms, pms, w, plain_on, fold=fold,
                 ms_external_noise=ms_ext)
            del out, ref, out_s, rf, rf_s, args
        if shape == HL1K:
            # hier-logistic-1k-mala's step: Philox noise with the fold
            vg = logistic_logp_grad(beta, x, y, m)
            lsm = torch.full((C, G), -1.3, device=dev)
            rf = (torch.randn(2, G, P, C, generator=d["gen"], device=dev),
                  torch.rand(2, G, P, C, generator=d["gen"], device=dev),
                  fold_rhat_scalars([11.0, 0.0], 11, 2048))
            args = (beta, *vg, lsm, mu, lt, x, y, m)
            out = fused_mala_logistic_step(*args, noise=(eps, logu),
                                           rhat_fold=rf)
            ref = fused_mala_logistic_step_plain(*args, (eps, logu),
                                                 rhat_fold=rf)
            torch.cuda.synchronize()
            err, ok, n_diff, n_bad = step_check(out, ref, beta, logu, 3)
            ms_ext = timed(lambda: fused_mala_logistic_step(
                *args, noise=(eps, logu), rhat_fold=rf))
            key = SweepRNG(seed, dev)
            ms = timed(lambda: fused_mala_logistic_step(*args, rng=key,
                                                        rhat_fold=rf))
            pms = timed(lambda: fused_mala_logistic_step_plain(
                *args, (eps, logu), rhat_fold=rf))
            w = work("mala_step", C, G, N, P, noise=False, fold=True)
            say(f"kernel mala_step fold [C={C} G={G} n={N} p={P}]: "
                f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|, alpha "
                f"2e-3|ref|); accept decisions differ in {n_diff} of "
                f"{C * G} cells, {n_bad} outside |log a - log u| < 1e-3 "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (Philox "
                f"noise; external noise {ms_ext:.4f} ms), plain {pms:.4f} "
                f"ms; {bound_str(w)} (Philox)")
            if not ok:
                fail("mala_step at p=4 disagrees with its plain version")
            cell("mala_step", shape, err, ms, pms, w, "full width", fold=True,
                 ms_external_noise=ms_ext)
            del out, ref, vg, rf, args
        del d, beta, mu, lt, eps, logu, x, y, m, v, g, h, ls, sl
        torch.cuda.empty_cache()

    # the value-only loglik at the shapes where group_loglik collects it,
    # one launch a retained draw: the judged and 1k-group presets
    for shape, data_seed, seed in ((JUDGED, 2000, 18), (HL1K, 2000, 19)):
        C, G, N, P = shape
        d = inputs(shape, data_seed, seed)
        beta, (x, y, m) = d["beta"], d["datasets"]["dense"]
        out, ref = logistic_loglik(beta, x, y, m), \
            loglik.logistic_loglik_padded(beta, x, y, m)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, 1e-4)
        ms = timed(lambda: logistic_loglik(beta, x, y, m))
        pms = timed(lambda: loglik.logistic_loglik_padded(beta, x, y, m))
        w = work("loglik", C, G, N, P)
        say(f"kernel loglik [C={C} G={G} n={N} p={P}, group_loglik's "
            f"shape]: max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms; {bound_str(w)}")
        if not ok:
            fail(f"loglik at C={C} G={G} disagrees with its plain version")
        cell("loglik", shape, err, ms, pms, w, "full width",
             launches_per_draw_collected=1)
        del d, beta, x, y, m, out, ref
        torch.cuda.empty_cache()

    # ---- 3f. the binomial family's operands at config 2's shape: the
    # mask a trials weight (integers 0..10, zero-weight runs inside
    # groups), y the fraction of successes (hier_glm's binomial delegate)
    C, G, N, P = RW
    d = inputs(RW, 1000, 21)
    beta, mu, lt, eps, logu = (d[k] for k in ("beta", "mu", "lt", "eps",
                                              "logu"))
    x, gen = d["datasets"]["dense"][0], d["gen"]
    wm = torch.randint(0, 11, (G, N), generator=gen, device=dev).float()
    wm[::7, N // 2 - 2:N // 2 + 2] = 0.0
    yb = torch.where(wm > 0, torch.floor(
        torch.rand(G, N, generator=gen, device=dev) * (wm + 1.0))
        / wm.clamp_min(1.0), torch.zeros_like(wm))
    wlabel = "binomial weights 0..10"
    for name, kern, plain in (
        ("loglik", lambda *a: (logistic_loglik(*a),),
         lambda *a: (loglik.logistic_loglik_padded(*a),)),
        ("logp_grad", logistic_logp_grad, loglik.logistic_logp_grad_padded),
    ):
        out, ref = kern(beta, x, yb, wm), plain(beta, x, yb, wm)
        torch.cuda.synchronize()
        errs = [max_err(a, b, 1e-4) for a, b in zip(out, ref)]
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        ms = timed(lambda: kern(beta, x, yb, wm))
        pms = timed(lambda: plain(beta, x, yb, wm))
        w = work(name, C, G, N, P)
        say(f"kernel {name} [{wlabel}, C={C} G={G} n={N} p={P}]: "
            f"max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|) "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms; {bound_str(w)}")
        if not ok:
            fail(f"{name} on a binomial-weighted mask disagrees with its "
                 "plain version")
        cell(name, RW, err, ms, pms, w, "full width", mask=wlabel)
        del out, ref
    v, g, h = loglik.logistic_logp_grad_hess_padded(beta, x, yb, wm)
    ls = torch.zeros(C, G, device=dev)
    for frozen, fold in ((False, False), (True, True)):
        rf = None
        if fold:
            rf = (torch.randn(2, G, P, C, generator=gen, device=dev),
                  torch.rand(2, G, P, C, generator=gen, device=dev),
                  fold_rhat_scalars([11.0, 0.0], 11, 2048))
        args = (beta, v, g, h, ls, mu, lt, x, yb, wm)
        out = fused_newton_logistic_step(*args, noise=(eps, logu),
                                         frozen=frozen, rhat_fold=rf)
        ref = fused_newton_logistic_step_plain(*args, (eps, logu),
                                               frozen=frozen, rhat_fold=rf)
        torch.cuda.synchronize()
        if frozen and out[3] is not h:
            fail("frozen newton_step must return h itself")
        keep = [i for i in range(len(out)) if not (frozen and i == 3)]
        err, ok, n_diff, n_bad = step_check(
            [out[i] for i in keep], [ref[i] for i in keep], beta, logu,
            keep.index(4))
        ms_ext = timed(lambda: fused_newton_logistic_step(
            *args, noise=(eps, logu), frozen=frozen, rhat_fold=rf))
        key = SweepRNG(22, dev)
        ms = timed(lambda: fused_newton_logistic_step(
            *args, rng=key, frozen=frozen, rhat_fold=rf))
        pms = timed(lambda: fused_newton_logistic_step_plain(
            *args, (eps, logu), frozen=frozen, rhat_fold=rf))
        kname = "newton_step_frozen" if frozen else "newton_step_refresh"
        w = work(kname, C, G, N, P, noise=False, fold=fold)
        case = f"{'frozen' if frozen else 'refresh'}{'+fold' if fold else ''}"
        say(f"kernel newton_step {case} [{wlabel}, C={C} G={G} n={N} "
            f"p={P}]: max_abs_err {err:.3e} (tol 1e-3 + 1e-4|ref|, alpha "
            f"2e-3|ref|); accept decisions differ in {n_diff} of {C * G} "
            f"cells, {n_bad} outside |log a - log u| < 1e-3 "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms (Philox noise; "
            f"external noise {ms_ext:.4f} ms), plain {pms:.4f} ms; "
            f"{bound_str(w)} (Philox)")
        if not ok:
            fail(f"newton_step {case} on a binomial-weighted mask disagrees "
                 "with its plain version")
        cell(kname, RW, err, ms, pms, w, "full width", fold=fold,
             mask=wlabel, ms_external_noise=ms_ext)
        del out, ref, rf, args
    del d, beta, mu, lt, eps, logu, x, gen, wm, yb, v, g, h, ls
    torch.cuda.empty_cache()

    # ---- 4. Philox moments ----
    nrm, uni = philox_probe(512 * 256, (1234, 99), dev, p=4)
    x = nrm.double().cpu()
    n = x.numel()
    mean, std = float(x.mean()), float(x.std())
    frac2 = float((x.abs() > 2.0).double().mean())
    skew = float((x**3).mean())
    u = uni.double().cpu()
    checks = [
        abs(mean) < 4 / math.sqrt(n),
        abs(std - 1.0) < 4 / math.sqrt(2 * n),
        abs(frac2 - 0.0455) < 0.01,
        abs(skew) < 6 * math.sqrt(15 / n),
        float(u.min()) > 0.0 and float(u.max()) <= 1.0,
        abs(float(u.mean()) - 0.5) < 4 * math.sqrt(1 / 12 / n),
    ]
    say(f"philox: {n} normals mean {mean:.2e} sd {std:.5f} "
        f"P(|z|>2) {frac2:.4f} E[z^3] {skew:.2e}; uniforms in "
        f"[{float(u.min()):.3e}, {float(u.max()):.7f}] mean "
        f"{float(u.mean()):.5f} {'ok' if all(checks) else 'FAIL'}")
    if not all(checks):
        fail("Philox moments")

    # ---- 5. small-input references: card (kernels) vs CPU (plain) ----
    def small_reference(label, make, algorithm, names, block):
        small = {}
        for dv in ("cuda", "cpu"):
            model, sd = make(dv)
            small[dv] = sample(model, sd, SamplerConfig(
                kernel=KernelConfig(algorithm=algorithm),
                run=RunConfig(chains=32, warmup=200, draws=400, seed=3,
                              full_rhat=True, log_every_segment=False,
                              collect={k: None for k in names}),
            ))
        for name in names:
            dk = small["cuda"].diagnostics()[name]
            dp = small["cpu"].diagnostics()[name]
            se = (dk["mcse_mean"].cpu() ** 2 + dp["mcse_mean"] ** 2).sqrt()
            gap = (dk["mean"].cpu() - dp["mean"]).abs()
            ok = bool((gap < 4 * se).all())
            say(f"small reference {label} {name}: card "
                f"{dk['mean'].cpu().tolist()} vs cpu {dp['mean'].tolist()}, "
                f"max gap/MCSE {float((gap / se).max()):.2f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"small-input {label} posterior of {name} disagrees "
                     "with the CPU")
        ak = float(small["cuda"].accept_rates[block].mean())
        ap = float(small["cpu"].accept_rates[block].mean())
        say(f"small reference {label} {block} acceptance: card {ak:.4f} "
            f"cpu {ap:.4f}")
        if abs(ak - ap) >= 0.05:
            fail(f"small-input {label} {block} acceptance disagrees")

    for algorithm, tau_prior in (("newton", "invgamma"),
                                 ("mala", "halfnormal"),
                                 ("rwmh", "halfnormal")):
        def make_logistic(dv, tau_prior=tau_prior):
            sd, _ = synth_logistic(5, G=16, n=20, p=3, device=dv)
            return make_hier_logistic(sd, tau_prior=tau_prior), sd
        small_reference(algorithm, make_logistic, algorithm,
                        ("mu", "log_tau"), "beta")
    # ragged data: the invgamma prior for both routes; with half-normal
    # tau this small model's log tau mixes too slowly for a 0.05
    # acceptance check (the beta acceptance follows where tau sits)
    for algorithm, impl, tau_prior in (("newton", "bucket", "invgamma"),
                                       ("mala", "pallas-segment",
                                        "invgamma")):
        def make_ragged(dv, impl=impl, tau_prior=tau_prior):
            sd, _ = synth_logistic(5, G=96, n=32, p=3, ragged=True,
                                   min_obs=1, device=dv)
            nb = len(bucket.BucketLayout.build(sd.segment_ids, 96).buckets)
            if nb < 2:
                fail(f"small ragged data form {nb} size bucket(s), not >= 2")
            return make_hier_logistic(sd, tau_prior=tau_prior,
                                      loglik_impl=impl), sd
        small_reference(f"ragged {algorithm} ({impl})", make_ragged,
                        algorithm, ("mu", "log_tau"), "beta")
    for algorithm in ("rwmh", "mala", "newton"):
        def make_poisson(dv):
            sd, _ = synth_poisson3(5, G=8, subjects_per_group=3, n=10, p=2,
                                   device=dv)
            return make_nested_poisson(sd, tau_prior="invgamma"), sd
        small_reference(f"nested-poisson {algorithm}", make_poisson,
                        algorithm, ("mu", "log_tau_g", "log_tau_s"),
                        "beta_s")

    # ---- 6. the end-to-end paths at full width ----

    def logistic_shapes(C_, P_, k_):
        return lambda D: {"mu": (C_, D, P_), "log_tau": (C_, D, P_),
                          "beta": (C_, D, k_, P_)}

    def poisson_shapes(D):
        return {"mu": (512, D, 3), "log_tau_g": (512, D, 3),
                "log_tau_s": (512, D, 3), "beta_g": (512, D, 8, 3),
                "beta_s": (512, D, 8, 3)}

    def run_path(preset, expect, block, acc_range, shapes, full_rhat=None,
                 warmup=None, draws=None, gate=True, runner=None, check=None,
                 why="a short or cut schedule"):
        """Drive one path (bench.run of ``preset``, or ``runner``) and check
        its launches, R-hat (unless ``gate`` is False, for the reason
        ``why``), acceptance, finiteness and draw shapes, then
        ``check(post)`` where given."""
        runner = runner or (lambda **kw: bench.run(preset=preset, **kw))
        reset_launch_counts()
        result, post, run_info = runner(warmup=warmup, draws=draws,
                                        full_rhat=full_rhat)
        launches = launch_counts()
        W, D = run_info["warmup"], run_info["draws"]
        say(f"{preset} run: {json.dumps(run_info)}")
        print(json.dumps(result), flush=True)
        say(f"launches in the {preset} run: {launches}")
        for k, nl in launches.items():
            launches_total[k] = launches_total.get(k, 0) + nl
        want = {k: 0 for k in launches}
        want.update({k: f(W, D) for k, f in expect.items()})
        if launches != want:
            fail(f"{preset}: launches {launches} != expected {want}")
        worst = post.worst_rhat()
        acc = float(post.accept_rates[block].mean())
        n_par = run_info["n_params"]
        covered = sum(v.numel() for v in post.full_rhat.values())
        if covered != n_par:
            fail(f"{preset}: streamed R-hat covers {covered} of {n_par} "
                 "parameters")
        say(f"{preset}: worst all-param R-hat {worst:.5f} over {n_par} "
            f"parameters ({'gate < 1.01' if gate else 'NOT asserted: ' + why}"
            f"); {block} sampling acceptance {acc:.4f} (in "
            f"{acc_range}); ESS/s/GPU {result['value']} min-ESS/s "
            f"{result['min_ess_per_sec_per_chip']} on '{smi}'")
        if gate and not worst < 1.01:
            fail(f"{preset}: worst R-hat {worst}")
        if not acc_range[0] < acc < acc_range[1]:
            fail(f"{preset}: {block} acceptance {acc}")
        finite = all(bool(torch.isfinite(v).all())
                     for v in post.draws.values())
        finite &= all(bool(torch.isfinite(v).all())
                      for v in post.final_state.position.values())
        if not finite:
            fail(f"{preset}: NaN or inf in the draws or the final state")
        got = {k: tuple(v.shape) for k, v in post.draws.items()}
        if got != shapes(D):
            fail(f"{preset}: draw shapes {got} != {shapes(D)}")
        if check is not None:
            check(post)
        del post
        torch.cuda.empty_cache()

    def segment_runner(algorithm):
        """ragged-10k-mala's data and config, the model built on the
        segment-kernel route with the preset's priors, ``algorithm`` on
        beta."""
        def run(**kw):
            model, data, cfg = get_preset("ragged-10k-mala", device=dev)
            model = make_hier_logistic(data, loglik_impl="pallas-segment")
            cfg = dataclasses.replace(cfg, kernel=dataclasses.replace(
                cfg.kernel, algorithm=algorithm))
            return bench.measure(
                model, data, cfg, f"ragged-10k pallas-segment {algorithm}",
                f"10k-group ragged hierarchical logistic, {algorithm}, "
                "segment kernels", **kw)
        return run

    def per_sweep(preset, runner=None):
        """(seconds a sweep, fixed seconds) at full width from a 10/10 run:
        the sweeps' wall over 20 (first sweeps included, so it errs long)
        and the rest of the run (data, set-up, diagnostics)."""
        runner = runner or (lambda **kw: bench.run(preset=preset, **kw))
        t0 = time.perf_counter()
        _, _, info = runner(warmup=10, draws=10)
        torch.cuda.empty_cache()
        sweeps = info["warmup_s"] + info["sample_s"]
        return sweeps / 20, time.perf_counter() - t0 - sweeps

    def need_s(est, sched):
        return 2.0 * est[1] + 1.15 * est[0] * sum(sched)

    def mu_tau_stats(post):
        """{name: (mean, MCSE)} of mu and tau = exp(log_tau), (p,) each."""
        dg = diagnose({"mu": post.draws["mu"],
                       "tau": torch.exp(post.draws["log_tau"])})
        return {k: (dg[k]["mean"].cpu(), dg[k]["mcse_mean"].cpu())
                for k in dg}

    rw_ref = {}     # the built-in RW run's posterior, for phase 9b
    run_path("hier-logistic-100-rw",
             {"rwmh_step": lambda W, D: W + D,
              "loglik": lambda W, D: W + D + 1},
             "beta", (0.1, 0.5), logistic_shapes(64, 4, 16), full_rhat=True,
             check=lambda post: rw_ref.update(mu_tau_stats(post)))

    # config 2: frozen-metric Newton, one step and one Laplace interweave
    # (its Hessian pass in warmup and once for the initial cache, its
    # gradient pass in sampling) a sweep, at full schedule
    newton_path = {"newton_step_refresh": lambda W, D: W,
                   "newton_step_frozen": lambda W, D: D,
                   "logp_grad_hess": lambda W, D: W + 1,
                   "logp_grad": lambda W, D: D}
    run_path("hier-logistic-100", newton_path, "beta", (0.5, 1.0),
             logistic_shapes(64, 4, 16))

    # config 1: plain PyTorch (no kernel), 4 chains, full schedule, against
    # the dense quadrature of the posterior
    ref8 = eight_schools_quadrature()

    def check_eight_schools(post):
        d = post.diagnostics()
        mu_err = abs(float(d["mu"]["mean"]) - ref8["mu_mean"])
        mu_se = float(d["mu"]["mcse_mean"])
        mu_var = float(post.var("mu"))
        var_tol = 6 * ref8["mu_var"] * math.sqrt(
            2 / float(d["mu"]["ess_bulk"]))
        tau = torch.exp(post.draws["log_tau"])
        tau_se = float(tau.std()) / math.sqrt(float(ess(tau)))
        tau_err = abs(float(tau.mean()) - ref8["tau_mean"])
        th_err = (d["theta"]["mean"].cpu().double()
                  - torch.tensor(ref8["theta_mean"])).abs()
        th_ratio = float((th_err / d["theta"]["mcse_mean"].cpu()).max())
        ok = (mu_err < 6 * mu_se and abs(mu_var - ref8["mu_var"]) < var_tol
              and tau_err < 6 * tau_se and th_ratio < 6)
        say(f"eight-schools vs quadrature: mu {float(d['mu']['mean']):.4f} "
            f"(quadrature {ref8['mu_mean']:.4f}, |err|/mcse "
            f"{mu_err / mu_se:.2f}), var {mu_var:.3f} ({ref8['mu_var']:.3f},"
            f" tol {var_tol:.3f}); tau {float(tau.mean()):.4f} "
            f"({ref8['tau_mean']:.4f}, |err|/se {tau_err / tau_se:.2f}); "
            f"theta max |err|/mcse {th_ratio:.2f} (tol 6) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("eight-schools disagrees with the quadrature")

    run_path("eight-schools", {}, "z", (0.2, 0.7),
             lambda D: {"z": (4, D, 8), "mu": (4, D), "log_tau": (4, D),
                        "theta": (4, D, 8)},
             check=check_eight_schools)

    # the exactness tier: the conjugate model's moments against the closed
    # form (tests/test_torch_exactness.py's schedule and z)
    t0 = time.perf_counter()
    edata = synth_hier_normal(11, G=15, n=8, sigma=1.0, tau=1.5, m0=0.0,
                              s0=3.0, device=dev)
    reset_launch_counts()
    epost = sample(
        make_hier_normal_known_scales(edata, sigma=1.0, tau=1.5, m0=0.0,
                                      s0=3.0),
        edata, SamplerConfig(run=RunConfig(chains=32, warmup=1500,
                                           draws=2500, seed=2,
                                           log_every_segment=False)))
    if any(launch_counts().values()):
        fail(f"the conjugate model launched {launch_counts()}")
    truth = analytic_hier_normal_posterior(edata, 1.0, 1.5, 0.0, 3.0)
    d = epost.diagnostics()
    e_mu = abs(float(d["mu"]["mean"]) - truth["mu_mean"]) / float(
        d["mu"]["mcse_mean"])
    e_muv = abs(float(epost.var("mu")) - truth["mu_var"]) / (
        truth["mu_var"] * math.sqrt(2.0 / float(d["mu"]["ess_bulk"])))
    e_th = float(((d["theta"]["mean"].cpu().double()
                   - torch.tensor(truth["theta_mean"])).abs()
                  / d["theta"]["mcse_mean"].cpu()).max())
    e_thv = float(((epost.var("theta").cpu().double()
                    - torch.tensor(truth["theta_var"])).abs()
                   / (torch.tensor(truth["theta_var"]) * torch.sqrt(
                       2.0 / d["theta"]["ess_bulk"].cpu().double()))).max())
    e_rhat = epost.worst_rhat()
    ok = e_rhat < 1.02 and max(e_mu, e_muv, e_th, e_thv) < 5.0
    say(f"exactness tier on the card ({time.perf_counter() - t0:.1f} s): "
        f"R-hat {e_rhat:.5f} (< 1.02); |err| in units of its standard error "
        f"(< 5): mu mean {e_mu:.2f}, mu var {e_muv:.2f}, theta means "
        f"{e_th:.2f}, theta vars {e_thv:.2f} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the exactness tier on the card")
    del epost, edata

    run_path("nested-poisson-1k",
             {"pois_rwmh_step": lambda W, D: W + D,
              "pois_loglik": lambda W, D: 1 + 2 * (W + D)},
             "beta_s", (0.1, 0.5), poisson_shapes)

    # config 4: every bucket runs one fused Newton step a sweep, and one
    # Hessian (warmup, and once for the initial cache) or gradient
    # (sampling) pass for the interweave's proposal
    run_path("ragged-10k",
             {"newton_step_refresh": lambda W, D: B * W,
              "newton_step_frozen": lambda W, D: B * D,
              "logp_grad_hess": lambda W, D: B * (W + 1),
              "logp_grad": lambda W, D: B * D},
             "beta", (0.5, 1.0), logistic_shapes(1024, 3, 8))

    # config 5's Newton variant at full width, depth cut: its launches
    # asserted, its R-hat printed (the full schedule's gate comes from
    # python -m nestmc_torch.bench --preset mala-100k-newton)
    run_path("mala-100k-newton", newton_path, "beta", (0.5, 1.0),
             logistic_shapes(512, 3, 8), warmup=200, draws=300, gate=False)

    # phases 7 and 8 run here, between phase 6's fixed paths and its cut
    # ones, so the cuts below see the time they actually took
    # ---- 7. the command line: run -> checkpoint -> resume -> compare ----
    import contextlib
    import io
    import os
    import shutil
    import subprocess
    import tempfile

    import numpy as np

    from nestmc_torch import cli
    from nestmc_torch.checkpoint import load_checkpoint, save_checkpoint
    from nestmc_torch.kernels.state import checkpoint_template

    t7 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="nestmc_smoke_")

    def cli_run(label, argv, expect):
        """cli.main(argv) on the card with its stdout captured and echoed;
        its launch counts, reset just before, must equal ``expect``.
        Returns (the last stdout line, seconds)."""
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        sec = time.perf_counter() - t0
        launches = launch_counts()
        out = buf.getvalue()
        print(out, end="", flush=True)
        say(f"cli {label} ({sec:.1f} s): rc {rc}; launches {launches}")
        if rc != 0:
            fail(f"cli {label}: exit code {rc}")
        want = {k: 0 for k in launches}
        want.update(expect)
        if launches != want:
            fail(f"cli {label}: launches {launches} != expected {want}")
        for k, nl in launches.items():
            launches_total[k] = launches_total.get(k, 0) + nl
        return out.strip().splitlines()[-1], sec

    # (a) config 2 at full width and schedule through the command line,
    # collecting group_loglik (one value-only loglik launch a retained
    # draw), checkpointing every segment of 1024
    W2, D2 = 1500, 4096
    path_a, path_r, path_b = (os.path.join(tmp, f) for f in
                              ("a.npz", "a_resumed.npz", "b.npz"))
    ck_a, ck_r = os.path.join(tmp, "ck"), os.path.join(tmp, "ck_resume")
    base = ["run", "--preset", "hier-logistic-100", "--collect",
            "mu,log_tau,beta:8,group_loglik", "--segment-size", "1024",
            "--checkpoint-every", "1", "--metric-json", "--quiet"]
    line, sec_a = cli_run("run hier-logistic-100", base + [
        "--checkpoint-dir", ck_a, "--save-draws", path_a],
        {"newton_step_refresh": W2, "newton_step_frozen": D2,
         "logp_grad_hess": W2 + 1, "logp_grad": D2, "loglik": D2})
    res_a = json.loads(line)
    za = dict(np.load(path_a))
    gll = za["group_loglik"]
    rh_a = {k[len("__full_rhat__."):]: v for k, v in za.items()
            if k.startswith("__full_rhat__.")}
    covered = sum(v.size for v in rh_a.values())
    ck_ms = 1e3 * res_a["timings"]["checkpoint_s"] / max(
        res_a["timings"]["checkpoints"], 1)
    say(f"cli config 2: worst R-hat {res_a['worst_rhat']:.5f} (gate < 1.01 "
        f"over {covered} streamed parameters and the collected scalars); "
        f"ESS/s/GPU {res_a['value']:.1f}; sample {res_a['sample_s']:.1f} s; "
        f"{res_a['timings']['checkpoints']} checkpoints at {ck_ms:.2f} ms "
        f"each; group_loglik {gll.shape}")
    if covered != 408 or res_a["rhat_params_streamed"] != 408:
        fail(f"cli config 2: streamed R-hat covers {covered} of 408")
    if not res_a["worst_rhat"] < 1.01:
        fail(f"cli config 2: worst R-hat {res_a['worst_rhat']}")
    if gll.shape != (64, D2, 100) or not np.isfinite(gll).all():
        fail(f"cli config 2: group_loglik {gll.shape}, finite "
             f"{bool(np.isfinite(gll).all())}")
    # group_loglik against the plain pass on the collected groups' betas
    _, d2data, _ = get_preset("hier-logistic-100", device=dev)
    x8, y8, m8 = d2data.x[:8], d2data.y[:8], d2data.mask[:8]
    errs = []
    for j in (0, 1, D2 // 2, D2 - 1):
        b8 = torch.from_numpy(za["beta"][:, j]).to(dev)
        ref = loglik.logistic_loglik_padded(b8, x8, y8, m8)
        errs.append(max_err(torch.from_numpy(gll[:, j, :8]).to(dev), ref,
                            1e-4))
    err = max(e for e, _ in errs)
    ok = all(o for _, o in errs)
    say(f"cli config 2: group_loglik of draws 0, 1, {D2 // 2}, {D2 - 1} "
        f"(the 8 collected groups) vs the plain pass: max_abs_err "
        f"{err:.3e} (tol 1e-3 + 1e-4|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("group_loglik disagrees with its plain version")
    record("loglik", err)
    # the added cost of collecting group_loglik, a retained draw
    m2, _, _ = get_preset("hier-logistic-100", device=dev)
    pos2 = m2.init_state(SweepRNG(4, dev), d2data, 64)
    buf2 = torch.empty(64, 8, 100, device=dev)
    gl_ms = timed(lambda: buf2[:, 3].copy_(m2.derived["group_loglik"](pos2)))
    say(f"cli config 2: group_loglik a retained draw (loglik launch + "
        f"buffer write) {gl_ms:.4f} ms")

    # (b) a crash after the second sample segment: resume from its
    # checkpoint; only the remaining draws run (the template's init pass
    # is one logp_grad_hess) and the all-parameter gate is the
    # uninterrupted run's
    os.makedirs(ck_r)
    for f in os.listdir(ck_a):
        ck_phase, _, ck_n = f.split(".")[0].split("_", 1)[1].rpartition("_")
        if ck_phase == "warmup" or int(ck_n) <= 2048:
            shutil.copy(os.path.join(ck_a, f), ck_r)
    line, sec_b = cli_run("run --resume", base + [
        "--checkpoint-dir", ck_r, "--resume", "--save-draws", path_r],
        {"newton_step_frozen": D2 - 2048, "logp_grad": D2 - 2048,
         "loglik": D2 - 2048, "logp_grad_hess": 1})
    res_r = json.loads(line)
    zr = dict(np.load(path_r))
    if res_r["timings"]["draws_run"] != D2 - 2048 or zr["mu"].shape[1] != (
            D2 - 2048):
        fail(f"resume ran {res_r['timings']['draws_run']} draws, not "
             f"{D2 - 2048}")
    gaps = {k: float(np.abs(zr["__full_rhat__." + k] - v).max())
            for k, v in rh_a.items()}
    bitwise = all(np.array_equal(zr["__full_rhat__." + k], v)
                  for k, v in rh_a.items()) and all(
        np.array_equal(zr[k], za[k][:, 2048:]) for k in
        ("mu", "log_tau", "beta", "group_loglik"))
    say(f"cli resume from sample_000002048: {D2 - 2048} draws in "
        f"{sec_b:.1f} s (load {1e3 * res_r['timings']['resume_s']:.1f} ms, "
        f"setup {1e3 * res_r['timings']['setup_s']:.1f} ms); finalized "
        f"all-parameter R-hat vs the uninterrupted run: max |diff| {gaps} "
        f"(tol 1e-5); bitwise {bitwise}")
    if not all(g <= 1e-5 for g in gaps.values()):
        fail("the resumed run's all-parameter R-hat differs")

    # checkpoint write and load at judged: the frozen (C, G, 10) packed
    # Hessian and the accumulators
    jm, jdata, jcfg = get_preset("judged", device=dev)
    jcarry = checkpoint_template(jm, jcfg, jdata, with_acc=True)
    jdir = os.path.join(tmp, "ck_judged")
    t0 = time.perf_counter()
    save_checkpoint(jdir, "sample_000002048", jcarry, {"phase": "sample"})
    j_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_checkpoint(jdir, "sample_000002048", jcarry)
    torch.cuda.synchronize()
    j_load = time.perf_counter() - t0
    j_mb = os.path.getsize(os.path.join(
        jdir, "carry_sample_000002048.npz")) / 1e6
    say(f"checkpoint at judged (C=1024, G=1000, p=4, with accumulators): "
        f"{j_mb:.1f} MB, write {1e3 * j_save:.1f} ms, load "
        f"{1e3 * j_load:.1f} ms")
    del jm, jdata, jcarry
    torch.cuda.empty_cache()

    # (c) the RW preset on the same data, then compare (both methods)
    rw_sched = ["--warmup", "1500", "--draws", "4096"]
    if left_s() < 150.0:
        rw_sched = ["--warmup", "500", "--draws", "1024"]
        say(f"CUT the cli RW run to warmup 500, draws 1024: {left_s():.0f} "
            "s left")
    Wr, Dr = int(rw_sched[1]), int(rw_sched[3])
    cli_run("run hier-logistic-100-rw", [
        "run", "--preset", "hier-logistic-100-rw", "--collect",
        "group_loglik", "--save-draws", path_b, "--metric-json", "--quiet",
        *rw_sched],
        {"rwmh_step": Wr + Dr, "loglik": Wr + 2 * Dr + 1})
    for method in ("loo", "waic"):
        line, sec = cli_run(f"compare --method {method}", [
            "compare", path_a, path_b, "--method", method], {})
        rows = json.loads(line)
        if len(rows) != 2 or not all(math.isfinite(r["elpd"])
                                     for r in rows):
            fail(f"compare {method}: {rows}")

    # (d) config 3's subject_loglik (pois_loglik) and group_loglik at one
    # position, card vs the CPU's plain version, timed as a pois_loglik
    # cell
    C, S, N, P = POIS
    pm, pd3, _ = get_preset("nested-poisson-1k", device=dev)
    cm, cd3, _ = get_preset("nested-poisson-1k", device="cpu")
    ppos = pm.init_state(SweepRNG(5, dev), pd3, C)
    cpos = {k: v.cpu() for k, v in ppos.items()}
    errs = {}
    for name in ("subject_loglik", "group_loglik"):
        out = pm.derived[name](ppos).cpu()
        errs[name] = max_err(out, cm.derived[name](cpos), 1e-4)
    ok = all(o for _, o in errs.values())
    ms = timed(lambda: pm.derived["subject_loglik"](ppos))
    const = loglik.poisson_const(pd3.y, pd3.mask)
    pms = timed(lambda: loglik.poisson_loglik_padded(
        ppos["beta_s"], pd3.x, pd3.y, pd3.mask, const))
    w = work("pois_loglik", C, S, N, P)
    say(f"config 3 subject_loglik / group_loglik [C={C} S={S} n={N} p={P}] "
        f"card vs CPU plain: max_abs_err "
        + ", ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
        + f" (tol 1e-3 + 1e-4|ref|) {'ok' if ok else 'FAIL'}; "
        f"subject_loglik {ms:.4f} ms, plain on the card {pms:.4f} ms; "
        f"{bound_str(w)}")
    if not ok:
        fail("config 3's per-unit logliks disagree with the CPU")
    cell("pois_loglik", POIS, errs["subject_loglik"][0], ms, pms, w,
         "full width", via="subject_loglik")
    del pm, pd3, cm, cd3, ppos, cpos

    # (e) the module entry point in its own process
    r = subprocess.run([sys.executable, "-m", "nestmc_torch",
                        "list-presets"], capture_output=True, text=True,
                       timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    names = [ln.split()[0] for ln in r.stdout.splitlines() if ln.strip()]
    say(f"python -m nestmc_torch list-presets: rc {r.returncode}, "
        f"{len(names)} presets")
    if r.returncode != 0 or len(names) != 16:
        fail(f"python -m nestmc_torch list-presets: {r.stderr[-2000:]}")
    shutil.rmtree(tmp, ignore_errors=True)
    say(f"phase 7 (the command line) took {time.perf_counter() - t7:.1f} s")

    # ---- 8. the hierarchical GLM, posterior-predictive checks, the CSV
    # loader (models/hier_glm.py, predictive.py, io/), on the card ----
    from nestmc_torch import posterior_predictive, predictive_pvalue
    from nestmc_torch.io import load_csv
    from nestmc_torch.io.build import native_lib
    from nestmc_torch.io.loaders import _load_csv_native, _load_csv_python
    from nestmc_torch.models import make_hier_glm, synth_glm

    t8 = time.perf_counter()
    tmp8 = tempfile.mkdtemp(prefix="nestmc_smoke8_")

    def glm_cfg(chains, collect, **kernel):
        return SamplerConfig(
            kernel=KernelConfig(algorithm="newton", **kernel),
            run=RunConfig(chains=chains, seed=0, full_rhat=True,
                          collect=collect, log_every_segment=False))

    def glm_runner(model, data, cfg, label, title):
        return lambda **kw: bench.measure(model, data, cfg, label, title,
                                          **kw)

    # (a) binomial at config 2's width: the logistic delegate on the
    # reweighted data (mask = trials, y = successes / trials), frozen
    # Newton at config 2's schedule; beta is collected in full for (d)
    bdata, _ = synth_glm(0, "binomial", G=100, n=50, p=4, trials=10,
                         device=dev)
    bmodel = make_hier_glm(bdata, family="binomial", tau_prior="invgamma")
    xw, yw, mw = bdata.x, bdata.y / 10.0, bdata.mask * 10.0
    log_binom = torch.sum(
        torch.lgamma(bdata.extra["trials"] + 1.0)
        - torch.lgamma(bdata.y + 1.0)
        - torch.lgamma(bdata.extra["trials"] - bdata.y + 1.0), dim=-1)

    def check_binomial(post):
        D = post.draws["beta"].shape[1]
        gll = post.draws["group_loglik"]
        errs = []
        for j in (0, 1, D // 2, D - 1):
            ref = loglik.logistic_loglik_padded(
                post.draws["beta"][:, j].contiguous(), xw, yw, mw
            ) + log_binom[None, :]
            errs.append(max_err(gll[:, j], ref, 1e-4))
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        say(f"hier_glm binomial: group_loglik of draws 0, 1, {D // 2}, "
            f"{D - 1} vs the plain pass on (y/m, mask m) plus the log "
            f"binomial coefficient: max_abs_err {err:.3e} (tol 1e-3 + "
            f"1e-4|ref|) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("hier_glm binomial group_loglik disagrees with the plain "
                 "pass")
        record("loglik", err)
        # (d) posterior-predictive replicates of (a)'s draws
        reset_launch_counts()
        t0 = time.perf_counter()
        y_rep = posterior_predictive(bmodel, post, bdata, SweepRNG(8, dev),
                                     num=64)
        pval = float(predictive_pvalue(y_rep, bdata))
        torch.cuda.synchronize()
        pp_s = time.perf_counter() - t0
        ok = (tuple(y_rep.shape) == (64, 100, 50)
              and bool(((y_rep >= 0) & (y_rep <= 10)).all())
              and bool((y_rep == torch.round(y_rep)).all())
              and 0.02 < pval < 0.98 and not any(launch_counts().values()))
        say(f"posterior_predictive on the binomial draws: {tuple(y_rep.shape)}"
            f" replicates in [{float(y_rep.min()):.0f}, "
            f"{float(y_rep.max()):.0f}] (trials 10), masked-mean p-value "
            f"{pval:.3f} (in (0.02, 0.98)), {1e3 * pp_s:.1f} ms with the "
            f"p-value, launches {launch_counts()} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("posterior_predictive on the binomial draws")

    newton_gl = {**newton_path, "loglik": lambda W, D: D}
    run_path("hier_glm binomial", newton_gl, "beta", (0.5, 1.0),
             lambda D: {"mu": (64, D, 4), "log_tau": (64, D, 4),
                        "beta": (64, D, 100, 4),
                        "group_loglik": (64, D, 100)},
             warmup=1500, draws=4096, full_rhat=True,
             runner=glm_runner(bmodel, bdata, glm_cfg(64, {
                 "mu": None, "log_tau": None, "beta": None,
                 "group_loglik": None}), "hier_glm binomial",
                 "G=100 binomial hierarchical GLM, trials 10, 64 chains, "
                 "frozen Newton on the logistic kernels"),
             check=check_binomial)
    del bdata, bmodel, xw, yw, mw, log_binom

    # (b) poisson at config 3's unit width: the fused Poisson steps with mu
    # broadcast as the per-group prior mean. Newton-MH's parameter-free
    # Laplace proposal traps a chain whose group starts far in its tail
    # (the reverse proposal's density is too small ever to accept; the
    # reference's Newton path traps the same groups): its launches are
    # asserted, its R-hat and trapped units printed; MALA, whose scales
    # adapt per unit, carries the gate at config 3's 16384 draws (2048
    # left its slowest groups at R-hat 1.03)
    pdata, _ = synth_glm(0, "poisson", G=4000, n=10, p=3, device=dev)
    pmodel = make_hier_glm(pdata, family="poisson", tau_prior="invgamma")
    pshapes = (lambda D: {"mu": (512, D, 3), "log_tau": (512, D, 3),
                          "beta": (512, D, 8, 3)})
    pcollect = {"mu": None, "log_tau": None, "beta": 8}

    def trapped(post):
        acc = post.accept_rates["beta"]
        stuck = acc < 0.01
        groups = sorted(set(stuck.nonzero()[:, 1].tolist()))
        say(f"hier_glm poisson newton: {int(stuck.sum())} of {acc.numel()} "
            f"(chain, group) units accept < 0.01 in sampling, in "
            f"{len(groups)} groups (first {groups[:10]})")

    run_path("hier_glm poisson newton",
             {"pois_newton_step_refresh": lambda W, D: W,
              "pois_newton_step_frozen": lambda W, D: D,
              "pois_logp_grad_hess": lambda W, D: W + 1,
              "pois_logp_grad": lambda W, D: D},
             "beta", (0.5, 1.0), pshapes, warmup=1000, draws=2048,
             full_rhat=True, gate=False, why="Laplace-proposal traps",
             runner=glm_runner(pmodel, pdata, glm_cfg(512, pcollect),
                               "hier_glm poisson newton",
                               "G=4000 poisson hierarchical GLM, 512 chains, "
                               "frozen Newton on the Poisson kernels"),
             check=trapped)
    run_path("hier_glm poisson mala",
             {"pois_mala_step": lambda W, D: W + D,
              "pois_logp_grad": lambda W, D: W + D + 1},
             "beta", (0.3, 0.9), pshapes, warmup=2000, draws=16384,
             full_rhat=True,
             runner=glm_runner(pmodel, pdata, dataclasses.replace(
                 glm_cfg(512, pcollect),
                 kernel=KernelConfig(algorithm="mala")),
                 "hier_glm poisson mala", "G=4000 poisson hierarchical "
                 "GLM, 512 chains, MALA on the Poisson kernels"))
    del pdata, pmodel
    torch.cuda.empty_cache()

    # (c) gaussian and negbin at config 2's width: plain PyTorch (their
    # likelihoods read the aux block), Newton on the zero-self split
    for family, aux, true_aux in (("gaussian", "log_sigma", math.log(0.7)),
                                  ("negbin", "log_r", math.log(5.0))):
        gdata, gtruth = synth_glm(0, family, G=100, n=50, p=4, device=dev)

        def check_aux(post, aux=aux, true_aux=true_aux, gtruth=gtruth,
                      family=family):
            d8 = post.diagnostics()
            gaps = {}
            for name, truth in (("mu", torch.tensor(gtruth["mu"])),
                                (aux, torch.tensor(true_aux))):
                m = d8[name]["mean"].cpu().double()
                sd = post.draws[name].double().std().cpu() if name == aux \
                    else post.draws[name].double().flatten(0, 1).std(0).cpu()
                gaps[name] = float(((m - truth).abs() / sd).max())
            acc = float(post.accept_rates[aux].mean())
            ok = all(g < 4.0 for g in gaps.values())
            say(f"hier_glm {family}: posterior mean vs synth_glm's truth, "
                f"max |mean - truth| / posterior sd: "
                + ", ".join(f"{k} {v:.2f}" for k, v in gaps.items())
                + f" (< 4); {aux} acceptance {acc:.3f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"hier_glm {family} misses the truth")

        run_path(f"hier_glm {family}", {}, "beta", (0.5, 1.01),
                 lambda D, aux=aux: {"mu": (64, D, 4), "log_tau": (64, D, 4),
                                     aux: (64, D), "beta": (64, D, 8, 4)},
                 warmup=500, draws=1024, full_rhat=True,
                 runner=glm_runner(
                     make_hier_glm(gdata, family=family, tau_prior="invgamma"),
                     gdata, glm_cfg(64, {"mu": None, "log_tau": None,
                                         aux: None, "beta": 8}),
                     f"hier_glm {family}", f"G=100 {family} hierarchical "
                     "GLM, 64 chains, Newton on the zero-self split, plain "
                     "PyTorch"),
                 check=check_aux)
        del gdata

    # (e) a CSV of ragged-10k's seed-0 data through load_csv: the native
    # parser and the numpy path give the arrays of from_numpy_ragged; then
    # 50 sweeps of config 4's bucket-route Newton on the loaded data
    rmodel, rdata, rcfg = get_preset("ragged-10k", device=dev)
    del rmodel
    seg_np = rdata.segment_ids.cpu().numpy()
    cols = np.column_stack([seg_np.astype(np.float64),
                            rdata.y.cpu().numpy().astype(np.float64),
                            rdata.x.cpu().numpy().astype(np.float64)])
    csv = os.path.join(tmp8, "ragged10k.csv")
    t0 = time.perf_counter()
    # 17 significant digits of the float32 values: exact after parsing
    np.savetxt(csv, cols, delimiter=",",
               fmt=["%d"] + ["%.17g"] * (cols.shape[1] - 1))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if native_lib() is None:
        from nestmc_torch.io.build import build_error
        fail(f"the native CSV parser did not build: {build_error()}")
    build_s = time.perf_counter() - t0

    def parse(native):
        t0 = time.perf_counter()
        out = load_csv(csv, native=native, device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    loaded, native_s = parse(True)
    native_s = min([native_s] + [parse(True)[1] for _ in range(2)])
    by_numpy, numpy_s = parse(False)
    # the host parse alone (no tensors built), each parser
    t0 = time.perf_counter()
    _load_csv_native(csv)
    parse_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _load_csv_python(csv)
    parse_numpy_s = time.perf_counter() - t0
    same = all(
        a.num_groups == rdata.num_groups
        and all(torch.equal(getattr(a, k), getattr(rdata, k))
                for k in ("y", "x", "segment_ids", "offsets"))
        for a in (loaded, by_numpy))
    mb = os.path.getsize(csv) / 1e6
    say(f"load_csv of ragged-10k's data ({loaded.num_obs} rows, "
        f"{loaded.num_groups} groups, p={loaded.num_covariates}; {mb:.1f} MB"
        f" written in {write_s:.2f} s): load_csv to the card, native parser"
        f" {1e3 * native_s:.1f} ms (best of 3; g++ build or load "
        f"{build_s:.2f} s), numpy path {1e3 * numpy_s:.1f} ms; the host "
        f"parse alone {1e3 * parse_native_s:.1f} ms native, "
        f"{1e3 * parse_numpy_s:.1f} ms numpy; arrays equal "
        f"from_numpy_ragged's {'ok' if same else 'FAIL'}")
    if not same:
        fail("load_csv's arrays differ from the data written")
    B8 = len(bucket.BucketLayout.build(loaded.segment_ids,
                                       loaded.num_groups).buckets)
    run_path("ragged-10k from CSV",
             {"newton_step_refresh": lambda W, D: B8 * W,
              "newton_step_frozen": lambda W, D: B8 * D,
              "logp_grad_hess": lambda W, D: B8 * (W + 1),
              "logp_grad": lambda W, D: B8 * D},
             "beta", (0.5, 1.0), logistic_shapes(1024, 3, 8),
             warmup=20, draws=30, gate=False,
             runner=glm_runner(
                 make_hier_logistic(loaded, tau_prior="invgamma"), loaded,
                 rcfg, "ragged-10k from CSV", "ragged-10k's data loaded "
                 "from CSV, bucket-route Newton"))
    del rdata, loaded, by_numpy, cols, seg_np
    shutil.rmtree(tmp8, ignore_errors=True)
    torch.cuda.empty_cache()
    say(f"phase 8 (hier_glm, predictive, CSV) took "
        f"{time.perf_counter() - t8:.1f} s")

    # ---- 9. the user-model toolkit and the data layer's converters ----
    from nestmc_torch import distributions as dist
    from nestmc_torch import transforms
    from nestmc_torch.data import NestedData, NestedData3, RaggedData
    from nestmc_torch.model import Block, ModelSpec, vmap_chains

    t9 = time.perf_counter()

    def same(label, pairs):
        """Fail unless each (ours, theirs) pair has one shape, dtype and
        the same bits."""
        bad = [k for k, (a, b) in pairs.items()
               if a.shape != b.shape or a.dtype != b.dtype
               or not torch.equal(a, b)]
        say(f"{label}: {', '.join(pairs)} "
            f"{'equal' if not bad else 'DIFFER in ' + ', '.join(bad)}")
        if bad:
            fail(f"{label}: {bad} differ")

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    # (a) the converters at full width. Config 4's seed-0 data (the
    # ragged-10k preset's) split into per-group lists and rebuilt
    G4 = 10_000
    rdata, _ = synth_logistic(4000, G=G4, n=30, p=3, ragged=True,
                              device=dev)
    off = rdata.offsets.cpu().numpy()
    yn, xn = rdata.y.cpu().numpy(), rdata.x.cpu().numpy()
    ys = [yn[off[g]:off[g + 1]] for g in range(G4)]
    xs = [xn[off[g]:off[g + 1]] for g in range(G4)]
    rr, ms_rr = host_ms(lambda: RaggedData.from_ragged(ys, xs, device=dev))
    nd, ms_nd = host_ms(lambda: NestedData.from_ragged(ys, xs, max_obs=30,
                                                       device=dev))
    back, ms_back = host_ms(nd.to_ragged)
    fields = ("y", "x", "segment_ids", "offsets")
    same(f"9a RaggedData.from_ragged ({ms_rr:.1f} ms) vs from_numpy_ragged"
         f" on config 4's seed-0 data (N={rdata.num_obs})",
         {k: (getattr(rr, k), getattr(rdata, k)) for k in fields})
    same(f"9a NestedData.from_ragged(max_obs=30) ({ms_nd:.1f} ms) -> "
         f"to_ragged() ({ms_back:.1f} ms) vs from_numpy_ragged",
         {k: (getattr(back, k), getattr(rdata, k)) for k in fields})
    gen9 = torch.Generator(device=dev).manual_seed(9)
    beta = 0.5 * torch.randn(1024, G4, 3, generator=gen9, device=dev)
    a = logistic_loglik(beta, nd.x, nd.y, nd.mask)
    b = logistic_loglik_segment(beta, back.x, back.y, SegmentLayout.build(
        back.segment_ids, back.num_groups))
    dd = (a - b).abs()
    ok = bool((dd <= 2e-5 + 2e-5 * b.abs()).all())
    say(f"9a loglik kernel on the padded form (1024, {G4}, 30, 3) vs the "
        f"seg_loglik kernel on the ragged form: max |a-b| "
        f"{float(dd.max()):.3e} (|a-b| <= 2e-5 + 2e-5|b|) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the padded and segment logliks disagree through the "
             "converters")
    del rdata, rr, nd, back, beta, a, b, dd, ys, xs

    # the judged data padded to 1024 groups: the obs passes on the padded
    # data against the unpadded ones on the 1000 real groups (cells are
    # independent: the same bits expected), exactly 0 on the 24 padded
    # groups, and one Newton refresh there without a NaN
    C9, P9 = 1024, 4
    jd9, _ = synth_logistic(2000, G=1000, n=50, p=P9, device=dev)
    jp9 = jd9.pad_groups_to(1024)
    if bool(jp9.mask[1000:].any()) or bool(jp9.sizes[1000:].any()):
        fail("pad_groups_to left a padded group with observations")
    beta = 0.5 * torch.randn(C9, 1024, P9, generator=gen9, device=dev)
    for name, fn in (("loglik", logistic_loglik),
                     ("logp_grad", logistic_logp_grad),
                     ("logp_grad_hess", logistic_logp_grad_hess)):
        full = fn(beta, jp9.x, jp9.y, jp9.mask)
        part = fn(beta[:, :1000].contiguous(), jd9.x, jd9.y, jd9.mask)
        full = full if isinstance(full, tuple) else (full,)
        part = part if isinstance(part, tuple) else (part,)
        errs = [max_err(f[:, :1000], q, 1e-4) for f, q in zip(full, part)]
        bitwise = all(torch.equal(f[:, :1000], q)
                      for f, q in zip(full, part))
        zero = all(float(f[:, 1000:].abs().max()) == 0.0 for f in full)
        err, ok = max(e for e, _ in errs), all(o for _, o in errs)
        say(f"9a pad_groups_to(1024) on the judged data, {name}: the 1000 "
            f"real groups {'bitwise equal to' if bitwise else 'NOT bitwise'}"
            f" the unpadded kernel's (max |diff| {err:.3e}); the 24 padded "
            f"groups exactly 0: {zero} {'ok' if ok and zero else 'FAIL'}")
        if not (ok and zero):
            fail(f"{name} on the padded judged data")
    v, g, h = logistic_logp_grad_hess(beta, jp9.x, jp9.y, jp9.mask)
    mu9 = 0.3 * torch.randn(C9, P9, generator=gen9, device=dev)
    lt9 = -0.7 + 0.2 * torch.randn(C9, P9, generator=gen9, device=dev)
    out = fused_newton_logistic_step(
        beta, v, g, h, torch.zeros(C9, 1, device=dev), mu9, lt9, jp9.x,
        jp9.y, jp9.mask, rng=SweepRNG(9, dev))
    finite = all(bool(torch.isfinite(t).all()) for t in out)
    acc_pad = float(out[4][:, 1000:].mean())
    say(f"9a newton_step refresh on the padded judged data: finite "
        f"{finite}; mean alpha of the padded groups {acc_pad:.4f} (their "
        "proposal is the prior's exact conditional)")
    if not finite:
        fail("newton_step on the padded judged data gave a NaN")
    del jd9, jp9, beta, v, g, h, out

    # config 3's seed-0 data as ys[g][s] lists, and a case with unequal
    # subjects per group
    pd3, _ = synth_poisson3(3000, G=1000, subjects_per_group=4, n=10, p=3,
                            device=dev)
    yn, xn = pd3.y.cpu().numpy(), pd3.x.cpu().numpy()
    keep = pd3.mask.cpu().numpy() > 0.5
    ys3, xs3 = [[] for _ in range(1000)], [[] for _ in range(1000)]
    for s_, g_ in enumerate(pd3.subject_group.cpu().tolist()):
        ys3[g_].append(yn[s_][keep[s_]])
        xs3[g_].append(xn[s_][keep[s_]])
    d3, ms_d3 = host_ms(lambda: NestedData3.from_ragged(ys3, xs3,
                                                        device=dev))
    same(f"9a NestedData3.from_ragged ({ms_d3:.1f} ms) vs from_numpy3 on "
         "config 3's seed-0 data",
         {k: (getattr(d3, k), getattr(pd3, k))
          for k in ("y", "mask", "x", "subject_group", "subject_counts")})
    if d3.members is not None or pd3.members is not None or not bool(
            (d3.subjects_per_group() == 4).all()):
        fail("config 3's groups of 4 subjects: members or subject counts")
    bs = 0.3 * torch.randn(512, d3.num_subjects, 3, generator=gen9,
                           device=dev)
    same("9a pois_loglik on NestedData3.from_ragged's data vs from_numpy3's",
         {"pois_loglik": (pois.poisson_loglik(bs, d3.x, d3.y, d3.mask),
                          pois.poisson_loglik(bs, pd3.x, pd3.y, pd3.mask))})
    r9 = np.random.default_rng(5)
    counts = [2, 0, 4, 1, 3]
    ysu = [[r9.poisson(2.0, size=int(r9.integers(1, 11))).astype(np.float32)
            for _ in range(c)] for c in counts]
    xsu = [[r9.normal(size=(len(y_), 3)) for y_ in grp] for grp in ysu]
    du = NestedData3.from_ragged(ysu, xsu, device=dev)
    sums = du.group_sum(torch.ones(2, du.num_subjects, device=dev))
    ok = (du.members is not None
          and du.subjects_per_group().tolist() == counts
          and sums.tolist() == [[float(c) for c in counts]] * 2)
    say(f"9a NestedData3.from_ragged with subjects per group {counts}: "
        f"members built {du.members is not None}, subjects_per_group "
        f"{du.subjects_per_group().tolist()}, group_sum of ones "
        f"{sums[0].tolist()} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("NestedData3.from_ragged with unequal subjects per group")
    del pd3, d3, bs, ys3, xs3
    torch.cuda.empty_cache()
    t9a = time.perf_counter() - t9

    # (b) a user's model: the hierarchical logistic written for ONE chain
    # with nestmc_torch.distributions and transforms (make_hier_logistic's
    # defaults: mu ~ N(0, 5), tau ~ HalfNormal(2) on the log transform with
    # its log-Jacobian and the log-scale guard), lifted by vmap_chains, at
    # config 2's width on the generic MALA path: no kernel of the port,
    # and its posterior of mu and tau against the built-in model's RW run
    # of phase 6 on the same data. The centred user model has no
    # interweaving move; 600/1200 sweeps (about 10-16 ms each, host-paced)
    # keep the phase near a minute, and its R-hat is printed, not gated
    def user_hier_logistic(G, p, mu_scale=5.0, tau_scale=2.0):
        lt_tr = transforms.log_transform

        def gprior(s):
            tau = lt_tr.forward(s["log_tau"])
            return torch.sum(dist.logpdf_normal(s["beta"], s["mu"], tau),
                             dim=-1)                            # (G,)

        def cond(name, value, state, data):
            s = {**state, name: value}
            if name == "beta":
                eta = torch.einsum("gnp,gp->gn", data.x, s["beta"])
                lik = dist.logpmf_bernoulli_logit(data.y, eta) * data.mask
                return torch.sum(lik, dim=-1) + gprior(s)
            if name == "mu":
                return torch.sum(gprior(s)) + torch.sum(
                    dist.logpdf_normal(s["mu"], 0.0, mu_scale))
            lt = s["log_tau"]
            return torch.sum(gprior(s)) + torch.sum(
                dist.logpdf_halfnormal(lt_tr.forward(lt), tau_scale)
                + lt_tr.log_jac(lt) + dist.log_scale_guard(lt))

        def init_state(rng, data, chains):
            return {"beta": 0.5 * rng.normal((G, p)),
                    "mu": 0.5 * rng.normal((p,)),
                    "log_tau": -1.0 + 0.2 * rng.normal((p,))}

        return vmap_chains(ModelSpec(
            name="user hier logistic",
            blocks=(Block("beta", (G, p), units=G, init_scale=0.3),
                    Block("mu", (p,), init_scale=0.1),
                    Block("log_tau", (p,), init_scale=0.1)),
            cond_logdensity=cond, init_state=init_state))

    UW, UD = 600, 1200
    udata, _ = synth_logistic(1000, G=100, n=50, p=4, device=dev)
    reset_launch_counts()
    upost = sample(user_hier_logistic(100, 4), udata, SamplerConfig(
        kernel=KernelConfig(algorithm="mala"),
        run=RunConfig(chains=64, warmup=UW, draws=UD, seed=0,
                      full_rhat=True, log_every_segment=False)))
    torch.cuda.synchronize()
    ulaunch = launch_counts()
    u_ms = 1e3 * (upost.timings["warmup_s"] + upost.timings["sample_s"]) / (
        UW + UD)
    us = mu_tau_stats(upost)
    z = {k: float(((us[k][0] - rw_ref[k][0]).abs() / torch.sqrt(
        us[k][1] ** 2 + rw_ref[k][1] ** 2)).max()) for k in us}
    ok = not any(ulaunch.values()) and max(z.values()) < 5.0
    uacc = {k: round(float(v.mean()), 4)
            for k, v in upost.accept_rates.items()}
    say(f"9b user model (vmap_chains, MALA, 64 chains, {UW}/{UD}) at "
        f"config 2's width: {u_ms:.2f} ms a sweep on '{smi}'; launches "
        f"{sum(ulaunch.values())} (must be 0); worst R-hat "
        f"{upost.worst_rhat():.5f} (printed, not asserted) at "
        f"{upost.worst_rhat_at()}; acceptance {uacc}")
    for k in us:
        say(f"9b {k}: user {[round(x, 4) for x in us[k][0].tolist()]} vs "
            f"built-in RW {[round(x, 4) for x in rw_ref[k][0].tolist()]}, "
            f"max |diff| / combined MCSE {z[k]:.2f} (< 5)")
    if not ok:
        fail("the user model launched a kernel or disagrees with the "
             "built-in model")
    del upost, udata
    t9b = time.perf_counter() - t9 - t9a

    # (c) same seed, same bits on the card: config 2 (frozen Newton with
    # the R-hat fold in the step kernel) and config 4's segment route
    # (MALA on the segment kernels), each twice at seed 0 and once at 1
    def det_check(label, build, sched, expect):
        model, data, cfg = build()
        runs = []
        for seed in (0, 0, 1):
            cfg_s = dataclasses.replace(cfg, run=dataclasses.replace(
                cfg.run, warmup=sched[0], draws=sched[1], seed=seed,
                log_every_segment=False))
            reset_launch_counts()
            post = sample(model, data, cfg_s)
            torch.cuda.synchronize()
            launches = launch_counts()
            want = {k: 0 for k in launches}
            want.update({k: f(*sched) for k, f in expect.items()})
            if launches != want:
                fail(f"9c {label}: launches {launches} != {want}")
            for k, nl in launches.items():
                launches_total[k] = launches_total.get(k, 0) + nl
            runs.append(post)
        a, b, c = runs
        differ = [k for k in a.draws if not torch.equal(a.draws[k],
                                                        b.draws[k])]
        differ += [f"full_rhat {k}" for k in (a.full_rhat or {})
                   if not torch.equal(a.full_rhat[k], b.full_rhat[k])]
        moved = not torch.equal(a.draws["mu"], c.draws["mu"])
        say(f"9c {label} {sched[0]}/{sched[1]}: two runs at seed 0 "
            f"{'bitwise equal' if not differ else 'DIFFER in ' + str(differ)}"
            f" over {', '.join(a.draws)}; seed 1 moves mu: {moved}; "
            f"launches a run {({k: n for k, n in want.items() if n})}")
        if differ or not moved:
            fail(f"9c {label}: same seed, other bits, or seed ignored")

    det_check("hier-logistic-100 (config 2)",
              lambda: get_preset("hier-logistic-100", device=dev),
              (150, 200), newton_path)

    def seg_build():
        _, data, cfg = get_preset("ragged-10k-mala", device=dev)
        return (make_hier_logistic(data, loglik_impl="pallas-segment"),
                data, cfg)

    det_check("ragged-10k pallas-segment mala", seg_build, (80, 100),
              {"seg_logp_grad": lambda W, D: 1 + 2 * (W + D)})

    # the plain segment sum (the segment route's Hessian pass and every
    # segment kernel's plain version) at config 4's shape: the segmented
    # reduction repeats its bits; the float scatter-add it replaced is
    # shown for comparison (its atomics add in another order each run)
    sd, _ = synth_logistic(4000, G=G4, n=30, p=3, ragged=True, device=dev)
    vals = torch.randn(1024, sd.num_obs, generator=gen9, device=dev)

    def scatter_sum():
        return torch.zeros(1024, G4, device=dev).index_add_(
            1, sd.segment_ids, vals)

    def seg_sum():
        return loglik._segsum(vals, sd.segment_ids, G4)

    distinct = {}
    for name, fn in (("segment_reduce", seg_sum),
                     ("index_add_", scatter_sum)):
        distinct[name] = len({fn().cpu().numpy().tobytes()
                              for _ in range(10)})
    err = float((seg_sum() - scatter_sum()).abs().max())
    say(f"9c plain segment sum (1024, {sd.num_obs}) -> (1024, {G4}): "
        f"segment_reduce {distinct['segment_reduce']} distinct result(s) "
        f"of 10, {timed(seg_sum):.4f} ms; index_add_ (replaced) "
        f"{distinct['index_add_']} of 10, {timed(scatter_sum):.4f} ms; max "
        f"|diff| {err:.3e}")
    if distinct["segment_reduce"] != 1 or err > 1e-3:
        fail("the plain segment sum is not deterministic on the card")
    del sd, vals
    torch.cuda.empty_cache()
    t9c = time.perf_counter() - t9 - t9a - t9b

    # (d) simulation-based calibration on the card, tests/test_sbc.py's
    # sizes: C = 512 replicas as chains, each with its own data set, G=4,
    # N=3, L=127 draws thinned by 4; the true value's rank among each
    # replica's draws is uniform for a correct sampler (chi-square on 8
    # bins, p > 1e-3), and the posterior must contract below the prior
    from scipy import stats as st

    cmodel, sample_y = calibration_model(4, 3)
    for seed, warmup in ((42, 500), (43, 300)):
        truth = cmodel.prior_sample(SweepRNG(seed, dev), None, 512)
        cdata = {"y": sample_y(SweepRNG(seed + 1000, dev), truth["theta"])}
        reset_launch_counts()
        cpost = sample(cmodel, cdata, SamplerConfig(run=RunConfig(
            chains=512, warmup=warmup, draws=127, thin=4, seed=seed - 35,
            log_every_segment=False)))
        if any(launch_counts().values()):
            fail(f"9d the calibration model launched {launch_counts()}")
        pvals = {}
        for name, dr, tr in (
                ("mu", cpost.draws["mu"], truth["mu"]),
                ("log_tau", cpost.draws["log_tau"], truth["log_tau"]),
                ("theta[0]", cpost.draws["theta"][:, :, 0],
                 truth["theta"][:, 0])):
            ranks = torch.sum(dr < tr[:, None], dim=1).cpu().numpy()
            counts = np.bincount((ranks / 16).astype(int), minlength=8)[:8]
            chi2 = float(((counts - 64.0) ** 2 / 64.0).sum())
            pvals[name] = float(st.chi2.sf(chi2, 7))
        post_sd = float(cpost.draws["theta"][:, :, 0].std(dim=1).mean())
        prior_sd = float(truth["theta"][:, 0].std())
        ok = (min(pvals.values()) > 1e-3 if seed == 42
              else post_sd < 0.6 * prior_sd)
        pv = {k: round(v, 4) for k, v in pvals.items()}
        say(f"9d SBC seed {seed} ({warmup}/127 thinned by 4, 512 replicas; "
            f"{cpost.timings['warmup_s'] + cpost.timings['sample_s']:.1f} "
            f"s): rank chi-square p {pv} (> 1e-3 asserted at seed 42); "
            f"posterior sd of theta[0] "
            f"{post_sd:.3f} vs prior {prior_sd:.3f} (< 0.6x asserted at "
            f"seed 43) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"9d SBC at seed {seed}")
    t9d = time.perf_counter() - t9 - t9a - t9b - t9c
    say(f"phase 9 (converters, user model, determinism, SBC) took "
        f"{time.perf_counter() - t9:.1f} s: 9a {t9a:.1f}, 9b {t9b:.1f}, "
        f"9c {t9c:.1f}, 9d {t9d:.1f}")

    # ---- 6, continued: the paths cut to the time left ----
    full, p_full, s_full = (1500, 4096), (1000, 16384), (800, 2048)
    j_min, p_min, s_min = (300, 512), (1000, 1024), (200, 512)
    s_rw = (200, 200)           # the segment RW path: short, R-hat printed
    seg_mala = segment_runner("mala")
    est = {k: per_sweep(k) for k in ("mala-100k", "judged",
                                     "nested-poisson-1k-mala",
                                     "nested-poisson-1k-newton")}
    est["segment"] = per_sweep(None, seg_mala)
    variants = ("nested-poisson-1k-mala", "nested-poisson-1k-newton")

    def need_seg(sched):
        # the RW path: about the MALA one's cost a sweep
        return need_s(est["segment"], sched) + need_s(est["segment"], s_rw)

    need_m = need_s(est["mala-100k"], full)
    spare = (left_s() - 60.0 - need_m
             - need_s(est["judged"], j_min)
             - sum(need_s(est[v], p_min) for v in variants)
             - need_seg(s_min))
    m_sched = full
    if spare < 0:
        scale = max(0.25, 1.0 + spare / need_m)
        m_sched = (full[0], max(1024, int(full[1] * scale) // 4 * 4))
        say(f"CUT mala-100k: {full[0]}/{full[1]} needs ~{need_m:.0f} s and "
            f"{left_s():.0f} s are left: running warmup {m_sched[0]}, draws "
            f"{m_sched[1]} at full width")
    run_path("mala-100k",
             {"mala_step": lambda W, D: W + D,
              "logp_grad": lambda W, D: W + D + 1},
             "beta", (0.3, 0.9), logistic_shapes(512, 3, 8),
             warmup=m_sched[0], draws=m_sched[1], gate=m_sched == full)

    # config 4's segment route: ragged-10k-mala's model on the segment
    # kernels, MALA at full schedule unless the script would then not end
    # within 60% of its budget with the variants at their least and the
    # full judged run (its draws shrink then, to s_min at the least)
    need_v_min = sum(need_s(est[v], p_min) for v in variants)
    room = (left_s() - 0.4 * BUDGET_S - need_s(est["judged"], full)
            - need_v_min)
    sm_sched = s_full
    if need_seg(s_full) > room:
        scale = max(room - need_seg(s_min), 0.0) / max(
            need_seg(s_full) - need_seg(s_min), 1e-9)
        sm_sched = (s_full[0], s_min[1] + int(
            (s_full[1] - s_min[1]) * min(scale, 1.0)) // 2 * 2)
        if scale <= 0.0:
            sm_sched = s_min
        say(f"CUT the segment MALA path: {s_full[0]}/{s_full[1]} needs "
            f"~{need_seg(s_full):.0f} s and {left_s():.0f} s are left: "
            f"running warmup {sm_sched[0]}, draws {sm_sched[1]} at full "
            "width")
    run_path("ragged-10k pallas-segment mala",
             {"seg_logp_grad": lambda W, D: 1 + 2 * (W + D)},
             "beta", (0.3, 0.9), logistic_shapes(1024, 3, 8),
             warmup=sm_sched[0], draws=sm_sched[1], gate=sm_sched == s_full,
             runner=seg_mala)
    run_path("ragged-10k pallas-segment rwmh",
             {"seg_loglik": lambda W, D: 1 + 2 * (W + D)},
             "beta", (0.1, 0.5), logistic_shapes(1024, 3, 8),
             warmup=s_rw[0], draws=s_rw[1], gate=False,
             runner=segment_runner("rwmh"))

    # config 3's variants run their full schedule only if the script would
    # still end within 60% of its budget after them and the full judged
    # run; otherwise their draws shrink first (to p_min at the least)
    need_v = sum(need_s(est[v], p_full) for v in variants)
    room = left_s() - 0.4 * BUDGET_S - need_s(est["judged"], full)
    v_sched = p_full
    if need_v > room:
        scale = max(room, 0.0) / need_v
        v_sched = (p_full[0], max(p_min[1], int(p_full[1] * scale) // 2 * 2))
        say(f"CUT config 3's variants: {p_full[0]}/{p_full[1]} needs "
            f"~{need_v:.0f} s and {left_s():.0f} s are left: running "
            f"warmup {v_sched[0]}, draws {v_sched[1]} at full width")
    run_path("nested-poisson-1k-mala",
             {"pois_mala_step": lambda W, D: W + D,
              "pois_logp_grad": lambda W, D: 1 + 2 * (W + D)},
             "beta_s", (0.3, 0.9), poisson_shapes,
             warmup=v_sched[0], draws=v_sched[1], gate=v_sched == p_full)
    run_path("nested-poisson-1k-newton",
             {"pois_newton_step_refresh": lambda W, D: W,
              "pois_newton_step_frozen": lambda W, D: D,
              "pois_logp_grad_hess": lambda W, D: 1 + 2 * W,
              "pois_logp_grad": lambda W, D: 2 * D},
             "beta_s", (0.5, 1.0), poisson_shapes,
             warmup=v_sched[0], draws=v_sched[1], gate=v_sched == p_full)

    need_j = need_s(est["judged"], full)
    avail = left_s() - 60.0
    j_sched = full
    if need_j > avail:
        scale = avail / need_j
        j_sched = (max(j_min[0], int(full[0] * scale)),
                   max(j_min[1], int(full[1] * scale) // 2 * 2))
        say(f"CUT judged: {full[0]}/{full[1]} needs ~{need_j:.0f} s, "
            f"{avail:.0f} s left: running warmup {j_sched[0]}, draws "
            f"{j_sched[1]} at full width")
    run_path("judged", newton_path, "beta", (0.5, 1.0),
             logistic_shapes(1024, 4, 8), warmup=j_sched[0],
             draws=j_sched[1], gate=j_sched == full)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SRC[k][0],
         "replaces": SRC[k][1], "launches": launches_total[k],
         "max_abs_err": kernels[k]["max_abs_err"], "ms": kernels[k]["ms"],
         "plain_ms": kernels[k]["plain_ms"],
         "bound_ms": kernels[k]["bound_ms"],
         "bound_by": kernels[k]["bound_by"], "library_ms": None,
         "shape_C_G_n_p": list(kernels[k]["shape"]),
         **{key: kernels[k][key] for key in ("ms_external_noise", "cells")
            if key in kernels[k]}}
        for k in SRC
    ]}), flush=True)
    say(f"total {time.perf_counter() - T_START:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
