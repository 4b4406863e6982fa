"""A/B of two kernel source trees on one card.

    python -m nestmc_torch.kernel_ab --base DIR [--shapes NAMES]
        [--cases REGEX] [--out FILE]
    python -m nestmc_torch.kernel_ab --sass [--base DIR]

DIR is another ``csrc`` tree, for example an earlier commit's
``nestmc_torch/csrc`` unpacked with ``git archive`` into a git-ignored
directory. Both trees are built for p=3 and p=4, and ptxas's registers and
spills of every instantiation of the tiled kernel templates and of the
noise fill are printed for each tree (one JSON line a kernel); then every
launch mode of those templates runs on both builds with the same inputs
and the same Philox key, at the shapes the main paths give it:

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
- ``segment_kernel``: seg_loglik and seg_logp_grad (at ``segment``);
- ``philox_fill_kernel``: the unit-axis noise fill in each mode (at
  ``fill``);
- the interweave's kernels (ops/cuda/asis.py): ``asis_stats`` at the
  current point and at the proposal, ``asis_propose`` and ``asis_accept``,
  in the Laplace mode with a Hessian a chain (at ``judged``) and in the
  Langevin mode with the shared bound metric (at ``mala-rank``). Their
  lines add the plain version's time and difference on the same inputs
  (``plain_ms``, ``plain_max_abs_diff``) and the bound (``bound_ms``,
  utils/profiling.kernel_work); a base tree without them gives
  ``base_ms`` null. Their wrappers take longer on the host than the
  kernels on the card, so these cases (``"timing": "graph"``) time ten
  calls captured as a CUDA graph and replayed, the plain version too
  (:func:`timed_graph`).

The shapes:

- ``mala-100k``: C=512 chains, G=100,000 groups, n=20, p=3;
- ``judged``: C=1024, G=1000, n=50, p=4;
- ``mala-rank``: a rank of mala-100k's 2 x 2 mesh, C=256, G=50,000, n=20,
  p=3 (the interweave's kernels only);
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
  are mostly the wrapper's);
- ``fill``: ragged-10k's (1024, 10000, 3) unit-axis draw, the noise fill
  in words, uniform, log-uniform and normal mode. Its lines say whether
  the two trees map elements to Philox words alike (``same_mapping``: the
  words modes equal); a base with another mapping (one Philox call an
  element, before the four-a-call fill) gives other bits, so its lines
  report the outputs' difference and ``bitwise_equal`` null.

The step kernels read their Philox key words and the fold's scalars from
device memory (nestmc_scalar_abi 2); a base tree built before that takes
them by value, and its step entry points are then called with the values
this script put at those pointers (:class:`_ByValue`), so both builds run
at the same key words and fold scalars.

One JSON line a case: the largest |new - base| over every output (0.0:
bitwise equal) and the two builds' ms, timed in turns base, new, new, base
(CUDA events; median over 7 batches of 10 back-to-back launches after
warm-up), with the card's nvidia-smi name and power limit. Needs a card.
``--cases`` keeps the cases whose name matches a regular expression (a
tuning A/B of one kernel).

``--sass`` builds the checkout's kernels (and DIR's, with ``--base``) for
p=3 and p=4 and prints, for each instantiation of the tiled kernel
templates and of the noise fill, its instruction count and the
instructions of its loops (backward branches) as ``cuobjdump -sass`` shows
them: the obs pass is the loop that holds the MUFU.EX2 operations.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import torch

SHAPES = ("mala-100k", "judged", "bucket", "config3", "segment", "rw",
          "fill", "mala-rank")
# the Logit case groups of each logistic shape (logistic_cases)
GROUPS = {"mala-100k": ("obs", "mala", "rw"),
          "judged": ("obs", "mala", "newton", "asis"),
          "bucket": ("obs", "mala", "newton"), "rw": ("rw",),
          "mala-rank": ("asis",)}
# the kernel templates whose registers, spills and SASS loops are reported:
# those on the (unit x chain) tile of csrc/cell_tile.cuh, and the noise fill
TILED = (r"logp_grad_kernel|loglik_kernel|rwmh_step_kernel|mala_step_kernel|"
         r"newton_step_kernel|segment_kernel|philox_fill_kernel")


# the values behind the device pointers this script passes: {data_ptr:
# host words or scalars}, for a base tree that takes them by value
_HOST: dict = {}


def _device_words(values, dtype, dev) -> torch.Tensor:
    """A device tensor of ``values`` whose pointer _ByValue can read back."""
    t = torch.tensor(values, dtype=dtype, device=dev)
    _HOST[t.data_ptr()] = [v for row in values for v in row] if isinstance(
        values[0], (list, tuple)) else list(values)
    return t


class _Key:
    """A fixed Philox key in place of a SweepRNG."""

    def __init__(self, k0: int, k1: int):
        self.key = (k0, k1)
        self._dev = {}

    def key_words(self, device):
        device = torch.device(device)
        if device not in self._dev:
            words = [w - (1 << 32) if w >= 1 << 31 else w for w in self.key]
            self._dev[device] = _device_words(words, torch.int32, device)
            _HOST[self._dev[device].data_ptr()] = list(self.key)
        return self._dev[device]


_P, _I, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float)
# the step entry points of a tree that takes the key words and the fold's
# scalars by value: (their argument types, the index of this tree's fold
# scalars pointer or None, the index of its key pointer)
_BY_VALUE = {
    "nestmc_newton_step": ([_P] * 21 + [_F] * 4 + [_I] * 3 + [_U] * 2
                           + [_I, _P] + [_I] * 3, 21, 25),
    "nestmc_mala_step": ([_P] * 19 + [_F] * 4 + [_I] * 3 + [_U] * 2 + [_P]
                         + [_I] * 3, 19, 23),
    "nestmc_rwmh_step": ([_P] * 13 + [_I] * 3 + [_U] * 2 + [_P] + [_I] * 3,
                         None, 16),
    "nestmc_pois_rwmh_step": ([_P] * 14 + [_I] * 3 + [_U] * 2 + [_P]
                              + [_I] * 3, None, 17),
    "nestmc_pois_mala_step": ([_P] * 16 + [_I] * 3 + [_U] * 2 + [_P]
                              + [_I] * 3, None, 19),
    "nestmc_pois_newton_step": ([_P] * 18 + [_I] * 3 + [_U] * 2 + [_I, _P]
                                + [_I] * 3, None, 21),
}


class _ByValue:
    """A base tree's library whose step entry points take the key words
    and the fold's scalars by value: called with this tree's arguments,
    it passes the values behind the pointers (_HOST; zeros for no key,
    the identity fold for none)."""

    def __init__(self, lib):
        self._lib = lib
        for name, (argtypes, _, _) in _BY_VALUE.items():
            getattr(lib, name).argtypes = argtypes

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in _BY_VALUE:
            return fn
        _, fsc_at, key_at = _BY_VALUE[name]

        def call(*args):
            args = list(args)
            key = args[key_at]
            key = (0, 0) if key is None else _HOST[key]
            out = args[:key_at] + list(key) + args[key_at + 1:]
            if fsc_at is not None:
                fsc = args[fsc_at]
                fsc = [1.0, 0.0, 1.0, 0.0] if fsc is None else _HOST[fsc]
                out = out[:fsc_at] + list(fsc) + out[fsc_at + 1:]
            return fn(*out)
        return call


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


def timed_graph(fn, batches: int = 7, per: int = 10) -> float:
    """ms a call as :func:`timed` gives it, with the ``per`` calls
    captured once as a CUDA graph and the graph replayed: the device time
    of calls whose Python costs more than their kernels take, as the
    engine's replayed steps run them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    return timed(graph.replay, batches, 1) / per


def logistic_inputs(shape, dev, seed):
    """synth_logistic's data at ``shape`` (C, G, n, p) on ``dev`` and a
    state and noise drawn from ``seed``."""
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
    r = logistic_inputs((C, G, wb.cap, p), dev, seed)
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
    fold = (r["fmean"], r["fm2"], _device_words(
        fold_rhat_scalars([11.0, 0.0], 11, 512).tolist(), torch.float32,
        beta.device))
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
    if "asis" in groups:
        cases += asis_cases(shape, r, laplace="newton" in groups)
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


def asis_inputs(shape, r, laplace: bool) -> dict:
    """The operands of one interweaving move at ``shape`` on the state of
    ``r``: the Laplace mode on the obs pass's Hessian, a chain each
    (``laplace``, the inverse-gamma tau prior), or the Langevin mode on the
    data's bound metric, shared by the chains (the half-normal prior).
    Keys: the arguments of ops/cuda/asis.py's wrappers, the current point's
    row and the proposal's (``row``, ``th_new``, ``aux``, ``row_new``)
    as the kernels give them, and the loglik and gradient there."""
    from nestmc_torch.models.hier_logistic import PopulationPrior
    from nestmc_torch.ops.cuda import asis
    from nestmc_torch.ops.cuda.loglik_logistic import (
        logistic_logp_grad,
        logistic_logp_grad_hess,
    )

    C, G, n, p = shape
    x, y, m, beta, mu, lt = (r[k] for k in ("x", "y", "mask", "beta", "mu",
                                            "lt"))
    dev = beta.device
    gen = torch.Generator(device=dev).manual_seed(5)
    prior = PopulationPrior(1.0 / 25.0, laplace, 2.0, 0.5, 2.0)
    if laplace:
        v, g, h = logistic_logp_grad_hess(beta, x, y, m)
        scale = None
    else:
        v, g = logistic_logp_grad(beta, x, y, m)
        h = torch.stack([0.25 * (m * x[..., i] * x[..., j]).sum(-1)
                         for i in range(p) for j in range(i + 1)], -1)[None]
        scale = torch.full((C, 1), 0.3, device=dev)
    eps = torch.randn(C, 2 * p, generator=gen, device=dev)
    logu = torch.log(torch.rand(C, generator=gen, device=dev))
    row = asis.asis_stats(beta, mu, g, h)
    th_new, aux, beta_new = asis.asis_propose(row, mu, lt, eps, scale, beta,
                                              prior)
    v_new, g_new = logistic_logp_grad(beta_new, x, y, m)
    row_new = asis.asis_stats(beta, mu, g_new, h, aux, (v_new, v))
    return dict(beta=beta, mu=mu, lt=lt, g=g, h=h, v=v, scale=scale,
                eps=eps, logu=logu, prior=prior, row=row, th_new=th_new,
                aux=aux, v_new=v_new, g_new=g_new, row_new=row_new)


def asis_cases(shape, r, laplace: bool):
    """(name, fn, extra) of the interweave's kernels at ``shape`` on the
    operands of :func:`asis_inputs`; ``extra`` holds the plain version of
    the call, its bound in ms and the library's entry point, which a base
    tree without the kernel lacks."""
    from nestmc_torch.ops.cuda import asis
    from nestmc_torch.utils.profiling import bound_ms, kernel_work

    C, G, n, p = shape
    a = asis_inputs(shape, r, laplace)
    beta, mu, lt, g, h, scale, prior = (a[k] for k in (
        "beta", "mu", "lt", "g", "h", "scale", "prior"))
    vv = (a["v_new"], a["v"])
    prop = (a["row"], mu, lt, a["eps"], scale, beta, prior)
    acc = (a["row_new"], a["th_new"], mu, lt, a["aux"], scale, a["logu"],
           prior)
    hn = 0 if h.shape[0] == 1 else p * (p + 1) // 2  # h's floats a cell

    def bound(*rec):
        return bound_ms(*kernel_work(*rec))[0]
    return [
        ("asis_stats current", lambda: (asis.asis_stats(beta, mu, g, h),),
         {"plain": lambda: (asis.asis_stats_plain(beta, mu, g, h),),
          "bound_ms": bound("asis_stats", C, G, 2 * p + hn, p),
          "timing": "graph", "entry": "nestmc_asis_stats"}),
        ("asis_stats proposal", lambda: (asis.asis_stats(
            beta, mu, a["g_new"], h, a["aux"], vv),),
         {"plain": lambda: (asis.asis_stats_plain(
             beta, mu, a["g_new"], h, a["aux"], vv),),
          "bound_ms": bound("asis_stats", C, G, 2 * p + hn + 2, p),
          "timing": "graph", "entry": "nestmc_asis_stats"}),
        ("asis_propose", lambda: asis.asis_propose(*prop),
         {"plain": lambda: asis.asis_propose_plain(*prop),
          "bound_ms": bound("asis_propose", C, G, 0, p),
          "timing": "graph", "entry": "nestmc_asis_propose"}),
        ("asis_accept", lambda: asis.asis_accept(*acc),
         {"plain": lambda: asis.asis_accept_plain(*acc),
          "bound_ms": bound("asis_accept", C, 0, 0, p),
          "timing": "graph", "entry": "nestmc_asis_accept"}),
    ]


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


def fill_cases(dev):
    """The noise fill at ragged-10k's (1024, 10000, 3) draw, each mode."""
    from nestmc_torch.ops.cuda.philox_fill import MODES, philox_fill

    shape = (1024, 10_000, 3)
    key = torch.tensor([0x2468ACE, -0x13579BD], dtype=torch.int32,
                       device=dev)
    return (shape[0], shape[1], 0, shape[2]), [
        (f"philox_fill {m}", lambda m=m: (philox_fill(
            shape, key, 0, 0, shape[1], m, dev),)) for m in MODES]


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
    return max(float((s.double() - t.double()).abs().max()) if s.numel()
               else 0.0 for s, t in zip(a, b))


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
    library = _build.library
    _build.SRC_DIR = base_src
    by_value = getattr(library(3), "nestmc_scalar_abi", None) is None
    _build.SRC_DIR = new_src
    wrapped = {}

    def base_library(p):
        if p not in wrapped:
            wrapped[p] = _ByValue(library(p))
        return wrapped[p]

    def on(src, fn):
        _build.SRC_DIR = src
        if src == base_src and by_value:
            _build.library = base_library
        try:
            return fn()
        finally:
            _build.SRC_DIR = new_src
            _build.library = library

    def report(shape_name, shape, cases, extra=None, mapping=None):
        """``mapping``: the case whose outputs show whether the two trees
        map alike (the fill's words); else the outputs are bitwise
        comparable."""
        same = None
        if mapping is not None:
            fn = dict(cases)[mapping]
            a, b = on(base_src, fn), on(new_src, fn)
            same = all(torch.equal(s, t) for s, t in zip(a, b))
            del a, b
            extra = {**(extra or {}), "same_mapping": same}
        for name, fn, *more in cases:
            if not re.search(args.cases, name):
                continue
            more = dict(more[0]) if more else {}
            plain = more.pop("plain", None)
            clock = timed_graph if more.get("timing") == "graph" else timed
            entry = more.pop("entry", None)
            base_has = entry is None or on(
                base_src, lambda: hasattr(_build.library(shape[-1]), entry))
            a = on(base_src, fn) if base_has else None
            b = on(new_src, fn)
            torch.cuda.synchronize()
            diff = None if a is None else _max_diff(a, b)
            if plain is not None:
                more["plain_max_abs_diff"] = _max_diff(plain(), b)
                more["plain_ms"] = clock(plain)
            del a, b
            t = [None if diff is None else on(base_src, lambda: clock(fn)),
                 on(new_src, lambda: clock(fn)),
                 on(new_src, lambda: clock(fn)),
                 None if diff is None else on(base_src, lambda: clock(fn))]
            line = json.dumps({
                "shape": shape_name, "C_G_n_p": list(shape), "kernel": name,
                "max_abs_diff": diff,
                "bitwise_equal": (None if same is False or diff is None
                                  else diff == 0.0),
                "base_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
                "speedup": (None if diff is None
                            else (t[0] + t[3]) / (t[1] + t[2])),
                "card": smi, **(extra or {}), **more,
            })
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

    for shape_name in args.shapes.split(","):
        extra = mapping = None
        if shape_name == "fill":
            shape, cases = fill_cases(dev)
            mapping = "philox_fill words"
        elif shape_name == "config3":
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
                         "rw": (64, 100, 50, 4),
                         "mala-rank": (256, 50_000, 20, 3)}[shape_name]
                r = logistic_inputs(shape, dev, 8)
            cases = logistic_cases(shape, r, GROUPS[shape_name])
        report(shape_name, shape, cases, extra, mapping)
        del cases
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
