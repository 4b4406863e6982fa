"""Bucketed evaluation of ragged likelihoods through the padded kernels.

Port of :mod:`nestmc.ops.bucket`: groups are partitioned into size buckets
with power-of-2 caps (padding under 2x), and the padded kernels (the obs
passes of ops/cuda/loglik_logistic, the fused MALA and Newton steps of
ops/cuda/mala_accept and newton_accept) run once per bucket, with a gather
of the bucket's groups before and a scatter (``index_copy_``) back to
(C, G) after. On CPU tensors the same route runs the plain versions.

The reference gathers each bucket's padded x and y inside its traced
functions, where XLA hoists them out of the sampling scan; eager PyTorch
would gather them every sweep. So the port gathers them once, when the
layout is built from the data (:meth:`BucketLayout.build` with ``x`` and
``y``), and the bucketed functions take the layout alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nestmc_torch.ops.cuda.loglik_logistic import (
    logistic_logp_grad,
    logistic_logp_grad_hess,
    logistic_loglik,
)
from nestmc_torch.ops.cuda.mala_accept import fused_mala_logistic_step
from nestmc_torch.ops.cuda.newton_accept import fused_newton_logistic_step


@dataclass(frozen=True)
class Bucket:
    """group_index (Gb,) int64 original group ids (on the data's device);
    obs_index (Gb, cap) int64 flat obs ids, -1 = padding (host); the
    bucket's padded data x (Gb, cap, p), y and mask (Gb, cap), or None
    for a layout built without data."""

    group_index: torch.Tensor
    obs_index: np.ndarray
    cap: int
    x: torch.Tensor | None = None
    y: torch.Tensor | None = None
    mask: torch.Tensor | None = None


@dataclass(frozen=True)
class BucketLayout:
    buckets: tuple            # tuple[Bucket, ...]
    num_groups: int
    covers_all: bool          # every group lies in a bucket

    @staticmethod
    def build(segment_ids, num_groups: int, edges=None,
              min_groups: int = 32, x=None, y=None) -> "BucketLayout":
        """Bucket groups by size with power-of-2 edges (or explicit
        ``edges``); buckets smaller than ``min_groups`` merge upward, and
        size-0 groups fall in no bucket (the reference's rule, bucket for
        bucket). With flat ``x`` (N, p) and ``y`` (N,) each bucket also
        holds its padded data, on their device."""
        if torch.is_tensor(segment_ids):
            segment_ids = segment_ids.cpu().numpy()
        seg = np.asarray(segment_ids, np.int64)
        if seg.size and np.any(np.diff(seg) < 0):
            raise ValueError("segment_ids must be sorted ascending")
        sizes = np.bincount(seg, minlength=num_groups)
        start = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        cap_max = int(sizes.max()) if num_groups else 0
        if edges is None:
            edges, e = [], 1
            while e < cap_max:
                e *= 2
                edges.append(e)
            if not edges:
                edges = [max(cap_max, 1)]
        dev = x.device if x is not None else torch.device("cpu")
        buckets, pending = [], []
        lo = 0
        for hi in edges:
            idx = np.where((sizes > lo) & (sizes <= hi))[0]
            lo = hi
            pending.append((hi, idx))
            total = sum(len(i) for _, i in pending)
            if total == 0:
                continue
            if total < min_groups and hi != edges[-1]:
                continue  # merge into the next bucket up
            cap = pending[-1][0]
            gidx = np.sort(np.concatenate([i for _, i in pending]))
            pending = []
            col = np.arange(cap, dtype=np.int64)[None, :]
            valid = col < sizes[gidx][:, None]
            obs = np.where(valid, start[gidx][:, None] + col, -1)
            data = {}
            if x is not None:
                safe = torch.from_numpy(np.maximum(obs, 0)).to(dev)
                vm = torch.from_numpy(valid.astype(np.float32)).to(dev)
                data = {"x": (x[safe] * vm[..., None]).contiguous(),
                        "y": (y[safe] * vm).contiguous(), "mask": vm}
            buckets.append(Bucket(
                group_index=torch.from_numpy(gidx).to(dev), obs_index=obs,
                cap=cap, **data,
            ))
        covered = sum(len(b.obs_index) for b in buckets)
        return BucketLayout(buckets=tuple(buckets), num_groups=num_groups,
                            covers_all=covered == num_groups)

    def padded_obs(self) -> int:
        return int(sum(b.obs_index.shape[0] * b.cap for b in self.buckets))


def covers_all_groups(layout: BucketLayout) -> bool:
    """True when every group falls in some bucket (no size-0 groups). The
    bucketed fused steps update only bucketed groups, and a size-0 group
    still needs its prior-only MH move, so the model offers them only
    then; the likelihood reductions leave a size-0 group's exact 0."""
    return layout.covers_all


def _out(layout: BucketLayout, shape, like: torch.Tensor):
    """An output every bucket's scatter fills, or zeros where some group
    lies in no bucket."""
    if layout.covers_all:
        return like.new_empty(shape)
    return like.new_zeros(shape)


def _take(t, b: Bucket):
    return t.index_select(1, b.group_index)


def bucketed_logistic_loglik(beta, layout: BucketLayout):
    """(C, G, p) beta -> (C, G) loglik, one value-only obs pass per
    bucket."""
    C, G, _ = beta.shape
    ll = _out(layout, (C, G), beta)
    for b in layout.buckets:
        ll.index_copy_(1, b.group_index,
                       logistic_loglik(_take(beta, b), b.x, b.y, b.mask))
    return ll


def bucketed_logistic_logp_grad(beta, layout: BucketLayout):
    """((C, G) loglik, (C, G, p) grad), one obs pass per bucket."""
    C, G, p = beta.shape
    ll, grad = _out(layout, (C, G), beta), _out(layout, (C, G, p), beta)
    for b in layout.buckets:
        llb, gb = logistic_logp_grad(_take(beta, b), b.x, b.y, b.mask)
        ll.index_copy_(1, b.group_index, llb)
        grad.index_copy_(1, b.group_index, gb)
    return ll, grad


def bucketed_logistic_logp_grad_hess(beta, layout: BucketLayout):
    """((C, G) loglik, (C, G, p) grad, (C, G, T) packed -Hessian): the
    Newton obs pass per bucket."""
    C, G, p = beta.shape
    T = p * (p + 1) // 2
    ll, grad = _out(layout, (C, G), beta), _out(layout, (C, G, p), beta)
    hess = _out(layout, (C, G, T), beta)
    for b in layout.buckets:
        llb, gb, hb = logistic_logp_grad_hess(_take(beta, b), b.x, b.y,
                                              b.mask)
        ll.index_copy_(1, b.group_index, llb)
        grad.index_copy_(1, b.group_index, gb)
        hess.index_copy_(1, b.group_index, hb)
    return ll, grad, hess


def _bucket_args(b: Bucket, log_scale, noise):
    """The bucket's log scale (per unit or shared) and external noise."""
    ls = _take(log_scale, b) if log_scale.shape[-1] != 1 else log_scale
    nz = None
    if noise is not None:
        nz = (_take(noise[0], b), _take(noise[1], b))
    return ls, nz


def bucketed_fused_mala_step(beta, v, g, log_scale, mu, log_tau,
                             layout: BucketLayout, rng=None, noise=None):
    """One fused MALA step (ops/cuda/mala_accept) per size bucket: each
    bucket is a partition of the conditionally independent group block,
    so the composition is the whole-block update. Each launch keys its
    Philox streams with its own ``rng.philox_key()`` (the reference's
    fold_in(key, bucket)); ``noise=(eps (C, G, p), logu (C, G))`` is
    gathered per bucket. Requires covers_all_groups(layout).
    Returns (new_beta, new_v, new_g, alpha (C, G))."""
    C, G, p = beta.shape
    nb, nv = _out(layout, (C, G, p), beta), _out(layout, (C, G), beta)
    ng, alpha = _out(layout, (C, G, p), beta), _out(layout, (C, G), beta)
    for b in layout.buckets:
        ls, nz = _bucket_args(b, log_scale, noise)
        outs = fused_mala_logistic_step(
            _take(beta, b), _take(v, b), _take(g, b), ls, mu, log_tau,
            b.x, b.y, b.mask, rng=rng, noise=nz,
        )
        for dst, src in zip((nb, nv, ng, alpha), outs):
            dst.index_copy_(1, b.group_index, src)
    return nb, nv, ng, alpha


def bucketed_fused_newton_step(beta, v, g, h, log_scale, mu, log_tau,
                               layout: BucketLayout, rng=None, noise=None,
                               frozen: bool = False):
    """Newton-MH analog of :func:`bucketed_fused_mala_step`
    (ops/cuda/newton_accept per bucket). frozen: the carried packed
    Hessian is a constant metric, the per-bucket kernels skip the Hessian
    sums, and ``h`` itself is returned as new_h.
    Returns (new_beta, new_v, new_g, new_h, alpha (C, G))."""
    C, G, p = beta.shape
    nb, nv = _out(layout, (C, G, p), beta), _out(layout, (C, G), beta)
    ng, alpha = _out(layout, (C, G, p), beta), _out(layout, (C, G), beta)
    nh = h if frozen else _out(layout, tuple(h.shape), h)
    for b in layout.buckets:
        ls, nz = _bucket_args(b, log_scale, noise)
        outs = fused_newton_logistic_step(
            _take(beta, b), _take(v, b), _take(g, b), _take(h, b), ls, mu,
            log_tau, b.x, b.y, b.mask, rng=rng, noise=nz, frozen=frozen,
        )
        dsts = (nb, nv, ng, None if frozen else nh, alpha)
        for dst, src in zip(dsts, outs):
            if dst is not None:
                dst.index_copy_(1, b.group_index, src)
    return nb, nv, ng, nh, alpha
