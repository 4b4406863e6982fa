"""A/B of two kernel source trees on one card.

    python -m nestmc_torch.kernel_ab --base DIR [--shapes NAMES]
        [--cases REGEX] [--out FILE]
    python -m nestmc_torch.kernel_ab --sass [--base DIR]

DIR is another ``csrc`` tree, for example an earlier commit's
``nestmc_torch/csrc`` unpacked with ``git archive`` into a git-ignored
directory. Both trees are built for p=3 and p=4, and ptxas's registers and
spills of every instantiation of the tiled kernel templates are printed
for each tree (one JSON line a kernel); then every launch mode of the
tiled templates runs on both builds with the same inputs and the same
Philox key, at the shapes the main paths give it:

- ``logp_grad_kernel``: logp_grad and logp_grad_hess, Logit and Poisson;
- ``loglik_kernel``: the value-only loglik, Logit (at ``mala-100k`` and
  ``rw``) and Poisson;
- ``rwmh_step_kernel``: external and Philox noise, Logit (at
  ``mala-100k`` and ``rw``) and Poisson;
- ``mala_step_kernel``: external noise, with and without the R-hat fold,
  and Philox noise, Logit and Poisson;
- ``newton_step_kernel``: Logit refresh, frozen and frozen with the fold,
  each with external and with Philox noise (at ``judged`` and
  ``bucket``), Poisson refresh and frozen, external and Philox (at
  ``config3``);
- ``segment_kernel``: seg_loglik and seg_logp_grad (at ``segment``).

The shapes:

- ``mala-100k``: C=512 chains, G=100,000 groups, n=20, p=3;
- ``judged``: C=1024, G=1000, n=50, p=4;
- ``bucket``: ragged-10k's widest size bucket at seed 0 (C=1024, 5,419
  groups, cap 32, p=3, masked);
- ``config3``: C=512, S=4000 subjects, n=10, p=3 (the Poisson modes);
- ``segment``: ragged-10k's full SegmentLayout at seed 0 (C=1024,
  G=10,000 groups of 5..30 observations, N=175,052, p=3); its first line
  also gives the share of warp slots the segment tile leaves idle while a
  block's warps wait for its longest group list (from the layout's group
  sizes and the tile plan, no timing);
- ``rw``: hier-logistic-100-rw's shape, C=64, G=100, n=50, p=4 (the
  value-only loglik and the RW-MH step only; a few blocks, so the times
  are mostly the wrapper's).

One JSON line a case: the largest |new - base| over every output (0.0:
bitwise equal) and the two builds' ms, timed in turns base, new, new, base
(CUDA events; median over 7 batches of 10 back-to-back launches after
warm-up), with the card's nvidia-smi name and power limit. Needs a card.
``--cases`` keeps the cases whose name matches a regular expression (a
tuning A/B of one kernel).

``--sass`` builds the checkout's kernels (and DIR's, with ``--base``) for
p=3 and p=4 and prints, for each instantiation of the tiled kernel
templates, its instruction count and the instructions of its loops
(backward branches) as ``cuobjdump -sass`` shows them: the obs pass is the
loop that holds the MUFU.EX2 operations.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

SHAPES = ("mala-100k", "judged", "bucket", "config3", "segment", "rw")
# the Logit case groups of each logistic shape (logistic_cases)
GROUPS = {"mala-100k": ("obs", "mala", "rw"),
          "judged": ("obs", "mala", "newton"),
          "bucket": ("obs", "mala", "newton"), "rw": ("rw",)}
# the kernel templates on the (unit x chain) tile of csrc/cell_tile.cuh
TILED = (r"logp_grad_kernel|loglik_kernel|rwmh_step_kernel|mala_step_kernel|"
         r"newton_step_kernel|segment_kernel")


class _Key:
    """A fixed Philox key in place of a SweepRNG."""

    def __init__(self, k0: int, k1: int):
        self.key = (k0, k1)

    def philox_key(self):
        return self.key


def timed(fn, batches: int = 7, per: int = 10) -> float:
    """ms a call: the median over batches of the mean of ``per``
    back-to-back calls between two CUDA events, after warm-up."""
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


def _logistic_inputs(shape, dev, seed):
    from nestmc_torch.models import synth_logistic

    C, G, n, p = shape
    data, _ = synth_logistic(seed, G=G, n=n, p=p, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = {
        "x": data.x, "y": data.y, "mask": data.mask,
        "beta": 0.5 * torch.randn(C, G, p, generator=gen, device=dev),
        "mu": 0.3 * torch.randn(C, p, generator=gen, device=dev),
        "lt": -0.7 + 0.2 * torch.randn(C, p, generator=gen, device=dev),
        "eps": torch.randn(C, G, p, generator=gen, device=dev),
        "logu": torch.log(torch.rand(C, G, generator=gen, device=dev)
                          .clamp_min(1e-38)),
        "fmean": torch.randn(2, G, p, C, generator=gen, device=dev),
        "fm2": torch.rand(2, G, p, C, generator=gen, device=dev),
    }
    return r


def _bucket_inputs(dev, seed):
    from nestmc_torch.ops import bucket
    from nestmc_torch.presets import get_preset

    _, rdata, _ = get_preset("ragged-10k", device=dev)
    layout = bucket.BucketLayout.build(rdata.segment_ids, rdata.num_groups,
                                       x=rdata.x, y=rdata.y)
    wb = layout.buckets[-1]
    C, G, p = 1024, len(wb.obs_index), rdata.num_covariates
    r = _logistic_inputs((C, G, wb.cap, p), dev, seed)
    r.update(x=wb.x, y=wb.y, mask=wb.mask)
    return (C, G, wb.cap, p), r


def logistic_cases(shape, r, groups):
    """(name, fn) of the Logit launch modes at ``shape`` in ``groups``:
    "obs" (logp_grad, logp_grad_hess), "mala", "newton" and "rw" (the
    value-only loglik and the RW-MH step)."""
    from nestmc_torch.diagnostics import fold_rhat_scalars
    from nestmc_torch.ops.cuda.loglik_logistic import (
        logistic_loglik,
        logistic_logp_grad,
        logistic_logp_grad_hess,
    )
    from nestmc_torch.ops.cuda.mala_accept import fused_mala_logistic_step
    from nestmc_torch.ops.cuda.mh_accept import fused_rwmh_logistic_step
    from nestmc_torch.ops.cuda.newton_accept import fused_newton_logistic_step

    C, G, n, p = shape
    x, y, m, beta = r["x"], r["y"], r["mask"], r["beta"]
    ls = torch.full((C, G), -1.3, device=beta.device)
    noise = (r["eps"], r["logu"])
    fold = (r["fmean"], r["fm2"], fold_rhat_scalars([11.0, 0.0], 11, 512))
    cases = []
    if "obs" in groups:
        cases += [
            ("logp_grad", lambda: logistic_logp_grad(beta, x, y, m)),
            ("logp_grad_hess",
             lambda: logistic_logp_grad_hess(beta, x, y, m)),
        ]
    if "rw" in groups:
        rargs = (beta, logistic_loglik(beta, x, y, m), ls, r["mu"], r["lt"],
                 x, y, m)
        cases += [
            ("loglik", lambda: (logistic_loglik(beta, x, y, m),)),
            ("rwmh_step noise", lambda: fused_rwmh_logistic_step(
                *rargs, noise=noise)),
            ("rwmh_step philox", lambda: fused_rwmh_logistic_step(
                *rargs, rng=_Key(1234, 99))),
        ]
    if "mala" in groups:
        v, g = logistic_logp_grad(beta, x, y, m)
        args = (beta, v, g, ls, r["mu"], r["lt"], x, y, m)
        cases += [
            ("mala_step noise", lambda: fused_mala_logistic_step(
                *args, noise=noise)),
            ("mala_step noise+fold", lambda: fused_mala_logistic_step(
                *args, noise=noise, rhat_fold=fold)),
            ("mala_step philox", lambda: fused_mala_logistic_step(
                *args, rng=_Key(1234, 99))),
        ]
    if "newton" not in groups:
        return cases
    v, g, h = logistic_logp_grad_hess(beta, x, y, m)
    nargs = (beta, v, g, h, torch.zeros(C, G, device=beta.device), r["mu"],
             r["lt"], x, y, m)
    for mode, kw in (("refresh", {}), ("frozen", {"frozen": True}),
                     ("frozen+fold", {"frozen": True, "rhat_fold": fold})):
        cases += [
            (f"newton_step {mode} noise",
             lambda kw=kw: fused_newton_logistic_step(*nargs, noise=noise,
                                                      **kw)),
            (f"newton_step {mode} philox",
             lambda kw=kw: fused_newton_logistic_step(
                 *nargs, rng=_Key(1234, 99), **kw)),
        ]
    return cases


def poisson_cases(dev, seed):
    from nestmc_torch.models import synth_poisson3
    from nestmc_torch.ops import loglik
    from nestmc_torch.ops.cuda import loglik_poisson as pois
    from nestmc_torch.ops.cuda import poisson_accept as pacc

    C, S, n, p = 512, 4000, 10, 3
    d, _ = synth_poisson3(seed, G=S // 4, subjects_per_group=4, n=n, p=p,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    beta = 0.3 * torch.randn(C, S, p, generator=gen, device=dev)
    bgs = beta + 0.15 * torch.randn(C, S, p, generator=gen, device=dev)
    lts = -1.4 + 0.2 * torch.randn(C, p, generator=gen, device=dev)
    noise = (torch.randn(C, S, p, generator=gen, device=dev),
             torch.log(torch.rand(C, S, generator=gen, device=dev)
                       .clamp_min(1e-38)))
    const = loglik.poisson_const(d.y, d.mask)
    v, g, h = loglik.poisson_logp_grad_hess_padded(beta, d.x, d.y, d.mask,
                                                    const)
    ls = torch.full((C, S), -1.0, device=dev)
    args = (beta, v, g, ls, bgs, lts, d.x, d.y, d.mask)
    nargs = (beta, v, g, h, torch.zeros(C, S, device=dev), bgs, lts, d.x,
             d.y, d.mask)
    newton = [
        (f"pois_newton_step {mode} {tag}",
         lambda frozen=frozen, kw=kw: pacc.fused_newton_poisson_step(
             *nargs, frozen=frozen, const=const, **kw))
        for mode, frozen in (("refresh", False), ("frozen", True))
        for tag, kw in (("noise", {"noise": noise}),
                        ("philox", {"rng": _Key(1234, 99)}))
    ]
    return (C, S, n, p), [
        ("pois_loglik", lambda: (pois.poisson_loglik(
            beta, d.x, d.y, d.mask, const),)),
        ("pois_rwmh_step noise", lambda: pacc.fused_rwmh_poisson_step(
            beta, v, ls, bgs, lts, d.x, d.y, d.mask, noise=noise,
            const=const)),
        ("pois_rwmh_step philox", lambda: pacc.fused_rwmh_poisson_step(
            beta, v, ls, bgs, lts, d.x, d.y, d.mask, rng=_Key(1234, 99),
            const=const)),
        ("pois_logp_grad", lambda: pois.poisson_logp_grad(
            beta, d.x, d.y, d.mask, const)),
        ("pois_logp_grad_hess", lambda: pois.poisson_logp_grad_hess(
            beta, d.x, d.y, d.mask, const)),
        ("pois_mala_step noise", lambda: pacc.fused_mala_poisson_step(
            *args, noise=noise, const=const)),
        ("pois_mala_step philox", lambda: pacc.fused_mala_poisson_step(
            *args, rng=_Key(1234, 99), const=const)),
    ] + newton


def segment_cases(dev, seed):
    """ragged-10k's full segment layout at seed 0: the two segment kernels,
    and the warp-slot idle share of the segment tile on that layout."""
    from nestmc_torch.ops.cuda.common import SEG_OBS, tile_plan
    from nestmc_torch.ops.cuda.loglik_segment import (
        logistic_logp_grad_segment,
        logistic_loglik_segment,
    )
    from nestmc_torch.ops.segment import SegmentLayout
    from nestmc_torch.presets import get_preset

    _, rdata, _ = get_preset("ragged-10k", device=dev)
    G, p = rdata.num_groups, rdata.num_covariates
    C = 1024
    layout = SegmentLayout.build(rdata.segment_ids, G)
    gen = torch.Generator(device=dev).manual_seed(seed)
    beta = 0.5 * torch.randn(C, G, p, generator=gen, device=dev)
    x, y = rdata.x, rdata.y
    tg = tile_plan("seg", SEG_OBS, p)[0]
    idle = warp_idle_share(rdata.sizes().cpu(), tg)
    return (C, G, rdata.num_obs, p), idle, [
        ("seg_loglik", lambda: (logistic_loglik_segment(beta, x, y, layout),)),
        ("seg_logp_grad",
         lambda: logistic_logp_grad_segment(beta, x, y, layout)),
    ]


def warp_idle_share(sizes, tg: int) -> float:
    """The share of a segment tile's warp slots left idle while its warps
    wait for the longest: warp w of a tile of tg groups takes the groups
    w, w + warps, ... (warps = min(tg, 8)) and runs their observations;
    a block lasts as long as its longest warp. 1 - (observations) /
    (tiles x warps x longest warp's observations), summed over tiles."""
    warps = min(tg, 8)
    sizes = [int(v) for v in sizes]
    busy = slots = 0
    for g0 in range(0, len(sizes), tg):
        tile = sizes[g0:g0 + tg]
        loads = [sum(tile[w::warps]) for w in range(warps)]
        busy += sum(loads)
        slots += warps * max(loads)
    return 1.0 - busy / max(slots, 1)


def sass_loops(lib_path) -> list:
    """[(kernel, instructions, [(loop instructions, MUFU.EX2 in it)])] of
    the tiled templates in one built library, from cuobjdump -sass."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out, name, ins = [], None, []

    def flush():
        if name and re.search(TILED, name):
            loops = []
            for addr, op in ins:
                m = re.search(r"BRA\s+0x([0-9a-f]+)", op)
                if m and int(m.group(1), 16) < addr:
                    lo = int(m.group(1), 16)
                    body = [o for a, o in ins if lo <= a <= addr]
                    loops.append((len(body),
                                  sum("MUFU.EX2" in o for o in body)))
            out.append((name, len(ins), loops))

    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            flush()
            name, ins = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m and name:
            ins.append((int(m.group(1), 16), m.group(2)))
    flush()
    return out


def ptxas_report(log: str) -> list:
    """[{kernel, registers, spill_stores, spill_loads}] of the tiled
    templates' instantiations in one ``-Xptxas -v`` log."""
    out, rec = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            rec = {"kernel": m.group(1)} if re.search(TILED, m.group(1)) \
                else None
            if rec:
                out.append(rec)
            continue
        if rec is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            rec.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rec["registers"] = int(m.group(1))
    return out


def _max_diff(a, b) -> float:
    return max(float((s - t).abs().max()) if s.numel() else 0.0
               for s, t in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", default=None,
                    help="the other csrc tree (the A of the A/B)")
    ap.add_argument("--sass", action="store_true",
                    help="print the tiled kernels' instruction and loop "
                    "counts instead of timing")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help=f"comma-separated subset of {SHAPES}")
    ap.add_argument("--cases", default="",
                    help="time only the cases whose name matches this "
                    "regular expression")
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from nestmc_torch import bench
    from nestmc_torch.ops.cuda import _build

    if args.sass:
        trees = [("checkout", _build.SRC_DIR)]
        if args.base:
            trees.append(("base", Path(args.base).resolve()))
        for tag, src in trees:
            _build.SRC_DIR = src
            _build.build([3, 4])
            for p in (3, 4):
                for name, n_ins, loops in sass_loops(_build.library_path(p)):
                    print(json.dumps({"tree": tag, "p": p, "kernel": name,
                                      "instructions": n_ins,
                                      "loops_instructions_ex2": loops}))
        return 0
    if args.base is None:
        ap.error("--base is required unless --sass")
    dev = torch.device("cuda")
    smi = bench.gpu_query()
    new_src, base_src = _build.SRC_DIR, Path(args.base).resolve()
    out = open(args.out, "a") if args.out else None
    for tag, src in (("base", base_src), ("new", new_src)):
        _build.SRC_DIR = src
        _build.build([3, 4])
        for p in (3, 4):
            log = _build.library_path(p).with_suffix(".log")
            for rec in ptxas_report(log.read_text() if log.exists() else ""):
                line = json.dumps({"tree": tag, "p": p, **rec})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
    _build.SRC_DIR = new_src

    def on(src, fn):
        _build.SRC_DIR = src
        try:
            return fn()
        finally:
            _build.SRC_DIR = new_src

    def report(shape_name, shape, cases, extra=None):
        for name, fn in cases:
            if not re.search(args.cases, name):
                continue
            a = on(base_src, fn)
            b = on(new_src, fn)
            torch.cuda.synchronize()
            diff = _max_diff(a, b)
            del a, b
            t = [on(base_src, lambda: timed(fn)),
                 on(new_src, lambda: timed(fn)),
                 on(new_src, lambda: timed(fn)),
                 on(base_src, lambda: timed(fn))]
            line = json.dumps({
                "shape": shape_name, "C_G_n_p": list(shape), "kernel": name,
                "max_abs_diff": diff, "bitwise_equal": diff == 0.0,
                "base_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
                "speedup": (t[0] + t[3]) / (t[1] + t[2]), "card": smi,
                **(extra or {}),
            })
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

    for shape_name in args.shapes.split(","):
        extra = None
        if shape_name == "config3":
            shape, cases = poisson_cases(dev, 6)
        elif shape_name == "segment":
            shape, idle, cases = segment_cases(dev, 10)
            extra = {"warp_slots_idle_share": idle}
        else:
            if shape_name == "bucket":
                shape, r = _bucket_inputs(dev, 12)
            else:
                shape = {"mala-100k": (512, 100_000, 20, 3),
                         "judged": (1024, 1000, 50, 4),
                         "rw": (64, 100, 50, 4)}[shape_name]
                r = _logistic_inputs(shape, dev, 8)
            cases = logistic_cases(shape, r, GROUPS[shape_name])
        report(shape_name, shape, cases, extra)
        del cases
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
