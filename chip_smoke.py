"""GPU smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA card and this checkout (it builds the kernels from
``nestmc_torch/csrc``). Phases, one line or more each:

1. the card: nvidia-smi's name and power limit, torch's device name;
2. the kernel build (nvcc, sm_90a) and its seconds;
3. each kernel vs its plain PyTorch version at the judged shape (C=1024,
   G=1000, n=50, p=4): max error against the stated tolerance and both
   times (CUDA events; median over 7 batches of 10 back-to-back launches,
   after warm-up);
4. the moments of the in-kernel Philox normals and uniforms;
5. a small-input reference: the sampler on the card vs its plain version
   on the CPU at a small size (posterior means within 4 combined MCSEs);
6. the judged config end to end through nestmc_torch.bench at full width
   (cut in draws/warmup only if the time budget requires, and then said).
   Launch counters are reset just before and read just after; every kernel
   must have run, the worst all-parameter R-hat must be < 1.01, beta's
   sampling acceptance > 0.5, and nothing NaN.

Any failed check exits non-zero. The last lines are a JSON object of the
kernels, the nvidia-smi line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import sys
import time

T_START = time.perf_counter()
BUDGET_S = 1200.0           # the whole script, build included
JUDGED_SCHEDULE = (1500, 4096)
C, G, N, P = 1024, 1000, 50, 4


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this smoke test needs a GPU",
              file=sys.stderr)
        return 1

    # fails outside a checkout of the repo
    from nestmc_torch import KernelConfig, RunConfig, SamplerConfig, sample
    from nestmc_torch import bench
    from nestmc_torch.diagnostics import fold_rhat_scalars
    from nestmc_torch.models import make_hier_logistic, synth_logistic
    from nestmc_torch.ops import loglik
    from nestmc_torch.ops.cuda import _build, launch_counts, reset_launch_counts
    from nestmc_torch.ops.cuda.loglik_logistic import (
        logistic_logp_grad,
        logistic_logp_grad_hess,
    )
    from nestmc_torch.ops.cuda.newton_accept import (
        fused_newton_logistic_step,
        fused_newton_logistic_step_plain,
        philox_probe,
    )

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

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.library(P)
    build_s = time.perf_counter() - t0
    info = _build.build_info.get(P, {})
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"build: p={P} in {build_s:.1f} s "
        f"({'compiled' if info else 'cached'}) -> "
        f"{_build.library_path(P).name}")
    for ln in ptxas:
        say(f"  ptxas: {ln}")

    # ---- 3. kernels vs plain at the judged shape ----
    data, _ = synth_logistic(2000, G=G, n=N, p=P, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    beta = 0.5 * torch.randn(C, G, P, generator=gen, device=dev)
    mu = 0.3 * torch.randn(C, P, generator=gen, device=dev)
    lt = -0.7 + 0.2 * torch.randn(C, P, generator=gen, device=dev)
    eps = torch.randn(C, G, P, generator=gen, device=dev)
    logu = torch.log(torch.rand(C, G, generator=gen, device=dev)
                     .clamp_min(1e-38))
    ls = torch.zeros(C, G, device=dev)
    masked_y = data.y.clone()
    masked_m = data.mask.clone()
    masked_m[:, N - 7:] = 0.0
    masked_y *= masked_m
    datasets = {"dense": (data.x, data.y, data.mask),
                "masked": (data.x, masked_y, masked_m)}

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

    def max_err(a, b, rtol):
        """max |a-b| and whether |a-b| <= 1e-3 + rtol |b| everywhere."""
        d = (a - b).abs()
        return float(d.max()), bool((d <= 1e-3 + rtol * b.abs()).all())

    kernels = {}

    def record(name, err, ms, plain_ms):
        k = kernels.setdefault(name, {"max_abs_err": 0.0})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if ms is not None:
            k["ms"], k["plain_ms"] = ms, plain_ms

    for name, kern, plain in (
        ("logp_grad", logistic_logp_grad, loglik.logistic_logp_grad_padded),
        ("logp_grad_hess", logistic_logp_grad_hess,
         loglik.logistic_logp_grad_hess_padded),
    ):
        for dname, (x, y, m) in datasets.items():
            out, ref = kern(beta, x, y, m), plain(beta, x, y, m)
            torch.cuda.synchronize()
            errs = [max_err(a, b, 1e-4) for a, b in zip(out, ref)]
            err = max(e for e, _ in errs)
            ok = all(o for _, o in errs)
            ms = timed(lambda: kern(beta, x, y, m))
            pms = timed(lambda: plain(beta, x, y, m))
            say(f"kernel {name} [{dname}]: max_abs_err {err:.3e} "
                f"(tol 1e-3 + 1e-4|ref|) {'ok' if ok else 'FAIL'}; "
                f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
            if not ok:
                fail(f"{name} [{dname}] disagrees with its plain version")
            record(name, err, ms if dname == "dense" else None, pms)

    for frozen in (False, True):
        for fold in (False, True):
            for dname, (x, y, m) in datasets.items():
                v, g, h = loglik.logistic_logp_grad_hess_padded(beta, x, y, m)
                rf = None
                if fold:
                    rf = (torch.randn(2, G, P, C, generator=gen, device=dev),
                          torch.rand(2, G, P, C, generator=gen, device=dev),
                          fold_rhat_scalars([11.0, 0.0], 11, 2048))
                args = (beta, v, g, h, ls, mu, lt, x, y, m)
                out = fused_newton_logistic_step(
                    *args, noise=(eps, logu), frozen=frozen, rhat_fold=rf)
                ref = fused_newton_logistic_step_plain(
                    *args, (eps, logu), frozen=frozen, rhat_fold=rf)
                torch.cuda.synchronize()
                acc_k = (out[0] != beta).any(-1)
                acc_p = (ref[0] != beta).any(-1)
                near = (torch.log(ref[4]) - logu).abs() < 1e-3
                differ = acc_k != acc_p
                n_near = int(near.sum())
                n_bad = int((differ & ~near).sum())
                same = ~differ
                errs = []
                for i in range(len(out)):
                    if i == 3 and frozen:
                        if out[3] is not h:
                            fail("frozen newton_step must return h itself")
                        continue
                    a, b = out[i], ref[i]
                    if i < 5:
                        msk = same if a.dim() == 2 else same[..., None]
                        a, b = a[msk.expand_as(a)], b[msk.expand_as(b)]
                    errs.append(max_err(a, b, 2e-3 if i == 4 else 1e-4))
                err = max(e for e, _ in errs)
                ok = all(o for _, o in errs) and n_bad == 0
                ms = timed(lambda: fused_newton_logistic_step(
                    *args, noise=(eps, logu), frozen=frozen, rhat_fold=rf))
                pms = timed(lambda: fused_newton_logistic_step_plain(
                    *args, (eps, logu), frozen=frozen, rhat_fold=rf))
                case = (f"{'frozen' if frozen else 'refresh'}"
                        f"{'+fold' if fold else ''} [{dname}]")
                say(f"kernel newton_step {case}: max_abs_err {err:.3e} "
                    f"(tol 1e-3 + 1e-4|ref|, alpha 2e-3|ref|); accept "
                    f"decisions differ in {int(differ.sum())} cells, all "
                    f"within |log a - log u| < 1e-3 ({n_near} such cells, "
                    f"{n_bad} outside) {'ok' if ok else 'FAIL'}; "
                    f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
                if not ok:
                    fail(f"newton_step {case} disagrees with its plain version")
                # the main path's cases: refresh without fold (warmup) and
                # frozen with fold (sampling), on the judged dense data
                main_case = dname == "dense" and fold == frozen
                record("newton_step_frozen" if frozen
                       else "newton_step_refresh", err,
                       ms if main_case else None, pms)
                del out, ref

    # ---- 4. Philox moments ----
    nrm, uni = philox_probe(512 * 256, (1234, 99), dev, p=P)
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

    # ---- 5. small-input reference: card (kernels) vs CPU (plain) ----
    small = {}
    for d in ("cuda", "cpu"):
        sd, _ = synth_logistic(5, G=16, n=20, p=3, device=d)
        small[d] = sample(
            make_hier_logistic(sd, tau_prior="invgamma"), sd,
            SamplerConfig(
                kernel=KernelConfig(algorithm="newton", fused_accept=True),
                run=RunConfig(chains=32, warmup=200, draws=400, seed=3,
                              full_rhat=True, log_every_segment=False,
                              collect={"mu": None, "log_tau": None}),
            ),
        )
    for name in ("mu", "log_tau"):
        dk = small["cuda"].diagnostics()[name]
        dp = small["cpu"].diagnostics()[name]
        se = (dk["mcse_mean"].cpu() ** 2 + dp["mcse_mean"] ** 2).sqrt()
        gap = (dk["mean"].cpu() - dp["mean"]).abs()
        ok = bool((gap < 4 * se).all())
        say(f"small reference {name}: card {dk['mean'].cpu().tolist()} vs "
            f"cpu {dp['mean'].tolist()}, max gap/MCSE "
            f"{float((gap / se).max()):.2f} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"small-input posterior of {name} disagrees with the CPU")
    ak = float(small["cuda"].accept_rates["beta"].mean())
    ap = float(small["cpu"].accept_rates["beta"].mean())
    say(f"small reference beta acceptance: card {ak:.4f} cpu {ap:.4f}")
    if abs(ak - ap) >= 0.05:
        fail("small-input beta acceptance disagrees with the CPU")

    # ---- 6. the judged config end to end ----
    warmup, draws = JUDGED_SCHEDULE
    # a short run at full width prices a sweep (data, set-up and the
    # diagnostics included, so the estimate errs long)
    probe_sweeps = 40
    t0 = time.perf_counter()
    bench.run(chains=C, warmup=probe_sweeps // 2, draws=probe_sweeps // 2)
    per_sweep = (time.perf_counter() - t0) / probe_sweeps
    left = BUDGET_S - (time.perf_counter() - T_START) - 90.0
    need = per_sweep * (warmup + draws) * 1.15
    if need > left:
        scale = left / need
        cut = (max(300, int(warmup * scale)),
               max(512, int(draws * scale) // 2 * 2))
        say(f"CUT: the schedule {warmup}/{draws} needs ~{need:.0f} s at "
            f"{per_sweep * 1e3:.1f} ms/sweep, {left:.0f} s left: running "
            f"warmup {cut[0]}, draws {cut[1]} at full width")
        warmup, draws = cut
    reset_launch_counts()
    result, post, run_info = bench.run(chains=C, warmup=warmup, draws=draws)
    launches = launch_counts()
    say(f"judged run: {json.dumps(run_info)}")
    print(json.dumps(result), flush=True)
    say(f"launches in the judged run: {launches}")
    for k, nl in launches.items():
        if nl <= 0:
            fail(f"kernel {k} was not launched on the main path")
    worst = post.worst_rhat()
    acc = float(post.accept_rates["beta"].mean())
    say(f"worst all-param R-hat {worst:.5f} (gate < 1.01); beta sampling "
        f"acceptance {acc:.4f} (> 0.5); ESS/s/GPU {result['value']} "
        f"min-ESS/s {result['min_ess_per_sec_per_chip']} on '{smi}'")
    if not worst < 1.01:
        fail(f"worst R-hat {worst}")
    if not acc > 0.5:
        fail(f"beta acceptance {acc}")
    finite = all(bool(torch.isfinite(v).all()) for v in post.draws.values())
    finite &= all(
        bool(torch.isfinite(v).all())
        for v in post.final_state.position.values()
    )
    if not finite:
        fail("NaN or inf in the draws or the final state")
    shapes = {k: tuple(v.shape) for k, v in post.draws.items()}
    expect = {"mu": (C, draws, P), "log_tau": (C, draws, P),
              "beta": (C, draws, 8, P)}
    if shapes != expect:
        fail(f"draw shapes {shapes} != {expect}")

    src = {
        "logp_grad": ("nestmc_torch/csrc/loglik_logistic.cu",
                      "nestmc/ops/pallas/loglik_logistic.py:343"),
        "logp_grad_hess": ("nestmc_torch/csrc/loglik_logistic.cu",
                           "nestmc/ops/pallas/loglik_logistic.py:289"),
        "newton_step_refresh": ("nestmc_torch/csrc/newton_accept.cu",
                                "nestmc/ops/pallas/newton_accept.py:392"),
        "newton_step_frozen": ("nestmc_torch/csrc/newton_accept.cu",
                               "nestmc/ops/pallas/newton_accept.py:392"),
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src[k][0],
         "replaces": src[k][1], "launches": launches[k],
         "max_abs_err": kernels[k]["max_abs_err"], "ms": kernels[k]["ms"],
         "plain_ms": kernels[k]["plain_ms"]}
        for k in src
    ]}), flush=True)
    say(f"total {time.perf_counter() - T_START:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
