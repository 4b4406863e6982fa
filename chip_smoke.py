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
   as extra "cells" of each kernel's record. mala_step's record times the
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
    from nestmc_torch.diagnostics import ess, fold_rhat_scalars
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

    def record(name, err, ms=None, plain_ms=None, shape=None, w=None):
        k = kernels.setdefault(name, {"max_abs_err": 0.0})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if ms is not None:
            b_ms, by = bound(*w)
            k.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                     shape=shape)

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
    def cell(name, shape, err, ms, pms, w, plain_on, **extra):
        """A timed record of ``name`` at another shape than its main one."""
        record(name, err)
        b_ms, by = bound(*w)
        kernels[name].setdefault("cells", []).append({
            "shape_C_G_n_p": list(shape), "ms": ms, "plain_ms": pms,
            "plain_on": plain_on, "bound_ms": b_ms, "bound_by": by,
            "max_abs_err": err, **extra})

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
    launches_total = {}

    def logistic_shapes(C_, P_, k_):
        return lambda D: {"mu": (C_, D, P_), "log_tau": (C_, D, P_),
                          "beta": (C_, D, k_, P_)}

    def poisson_shapes(D):
        return {"mu": (512, D, 3), "log_tau_g": (512, D, 3),
                "log_tau_s": (512, D, 3), "beta_g": (512, D, 8, 3),
                "beta_s": (512, D, 8, 3)}

    def run_path(preset, expect, block, acc_range, shapes, full_rhat=None,
                 warmup=None, draws=None, gate=True, runner=None, check=None):
        """Drive one path (bench.run of ``preset``, or ``runner``) and check
        its launches, R-hat, acceptance, finiteness and draw shapes, then
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
            f"parameters ({'gate < 1.01' if gate else 'NOT asserted: a short '
            'or cut schedule'}); {block} sampling acceptance {acc:.4f} (in "
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

    run_path("hier-logistic-100-rw",
             {"rwmh_step": lambda W, D: W + D,
              "loglik": lambda W, D: W + D + 1},
             "beta", (0.1, 0.5), logistic_shapes(64, 4, 16), full_rhat=True)

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

    full, p_full, s_full = (1500, 4096), (1000, 16384), (800, 2048)
    j_min, p_min, s_min = (300, 512), (1000, 2048), (200, 512)
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
    spare = (left_s() - 60.0 - need_m - need_s(est["judged"], j_min)
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
