"""A/B of the plain PyTorch paths of several checkouts on one card.

    python -m nestmc_torch.plain_ab DIR [DIR ...] [--out FILE]

Each DIR is the root of another checkout, for example an earlier commit
unpacked with ``git archive`` into a git-ignored directory; this checkout
is the last one. Each checkout runs in a subprocess of its own with its
root first on ``sys.path``, in turns forward and back (DIRs, this, this,
DIRs reversed), and times on the card:

- the plain padded obs passes of ``ops/loglik.py``: the logistic
  ``loglik``, ``logp_grad`` and ``logp_grad_hess`` at config 2's shape
  (C=64, G=100, n=50, p=4) and the judged shape (C=1024, G=1000, n=50,
  p=4), the Poisson ones at config 3's (C=512, S=4000, n=10, p=3): ms a
  call, the median over 7 batches of 10 back-to-back calls between CUDA
  events, after warm-up;
- a hier_glm gaussian and negbin run at config 2's width (synth_glm seed
  0, G=100, n=50, p=4, 64 chains, invgamma tau, Newton, 100/200; these
  families' likelihoods are plain PyTorch): ms a sweep, the run's warmup
  and sampling wall time over its sweeps.

One JSON line a checkout's run, then one line of each quantity's mean
over a checkout's two runs, with the card's nvidia-smi name and power
limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from nestmc_torch import KernelConfig, RunConfig, SamplerConfig, sample
from nestmc_torch.models import make_hier_glm, synth_glm
from nestmc_torch.ops import loglik as L


def timed(fn, batches=7, per=10):
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
    return sorted(times)[batches // 2]


dev = torch.device("cuda")
out = {}
for tag, (C, G, n, p), fams in (
        ("config2", (64, 100, 50, 4), ("logistic",)),
        ("judged", (1024, 1000, 50, 4), ("logistic",)),
        ("config3", (512, 4000, 10, 3), ("poisson",))):
    g = torch.Generator().manual_seed(0)
    x = (0.5 * torch.randn(G, n, p, generator=g)).to(dev)
    beta = (0.3 * torch.randn(C, G, p, generator=g)).to(dev)
    y = (torch.rand(G, n, generator=g) < 0.5).float().to(dev)
    mask = torch.ones(G, n, device=dev)
    for fam in fams:
        for pas in ("loglik", "logp_grad", "logp_grad_hess"):
            fn = getattr(L, f"{fam}_{pas}_padded")
            out[f"{tag} {fam} {pas} ms"] = timed(
                lambda: fn(beta, x, y, mask))
for family in ("gaussian", "negbin"):
    data, _ = synth_glm(0, family, G=100, n=50, p=4, device=dev)
    model = make_hier_glm(data, family=family, tau_prior="invgamma")
    cfg = SamplerConfig(kernel=KernelConfig(algorithm="newton"),
                        run=RunConfig(chains=64, warmup=100, draws=200,
                                      log_every_segment=False))
    sample(model, data, cfg)                            # warm-up run
    t = sample(model, data, cfg).timings
    out[f"hier_glm {family} ms a sweep"] = (
        1e3 * (t["warmup_s"] + t["sample_s"]) / 300)
print(json.dumps(out))
'''


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+", help="roots of the other checkouts")
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = [os.path.abspath(d) for d in args.dirs] + [here]
    order = trees + trees[::-1]
    smi = _smi()
    runs = {t: [] for t in trees}
    lines = []
    for tree in order:
        proc = subprocess.run([sys.executable, "-c", _RUN, tree], cwd=tree,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-3000:])
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(res)
        lines.append({"tree": tree, "device": smi, **res})
    lines.append({"mean of two runs": {
        t: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
        for t, rs in runs.items()}, "device": smi})
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
