"""Ragged (segment) Bernoulli-logit obs passes on the card
(csrc/loglik_segment.cu).

Port of nestmc/ops/pallas/loglik_segment.py::logistic_loglik_segment_pallas
and ::logistic_logp_grad_segment_pallas, with the same public layouts:
beta (C, G, p), flat x (N, p) and y (N,), and the dataset's
:class:`~nestmc_torch.ops.segment.SegmentLayout` -> loglik (C, G)[, grad
(C, G, p)]. The plain versions are the segment references of
:mod:`nestmc_torch.ops.loglik`.
"""

from __future__ import annotations

import torch

from nestmc_torch.ops import loglik as _plain
from nestmc_torch.ops.cuda import LAUNCHES, _build
from nestmc_torch.ops.cuda.common import check_tensor, on_cpu, ptr, stream_of
from nestmc_torch.ops.segment import SegmentLayout


def logistic_loglik_segment_plain(beta, x, y, layout: SegmentLayout):
    return _plain.logistic_loglik_segment(beta, x, y, layout.segment_ids,
                                          layout.num_groups)


def logistic_logp_grad_segment_plain(beta, x, y, layout: SegmentLayout):
    return _plain.logistic_logp_grad_segment(beta, x, y, layout.segment_ids,
                                             layout.num_groups)


def _launch(beta, x, y, layout: SegmentLayout, grad: bool):
    C, G, p = beta.shape
    N = layout.num_obs
    dev = beta.device
    if G != layout.num_groups:
        raise ValueError(f"beta has {G} groups, the layout {layout.num_groups}")
    for name, t, shape in (("beta", beta, (C, G, p)), ("x", x, (N, p)),
                           ("y", y, (N,))):
        check_tensor(t, name, shape, dev)
    if layout.offsets.device != dev or layout.offsets.dtype != torch.int32:
        raise ValueError("layout offsets: int32 on the data's device expected")
    out_v = torch.empty((C, G), dtype=torch.float32, device=dev)
    out_g = torch.empty((C, G, p), dtype=torch.float32, device=dev) if grad \
        else None
    if C == 0 or G == 0:
        return (out_v, out_g) if grad else out_v
    lib = _build.library(p)
    with torch.cuda.device(dev):
        if grad:
            rc = lib.nestmc_seg_logp_grad(
                ptr(x), ptr(y), ptr(layout.offsets), ptr(beta), ptr(out_v),
                ptr(out_g), C, G, stream_of(beta))
        else:
            rc = lib.nestmc_seg_loglik(
                ptr(x), ptr(y), ptr(layout.offsets), ptr(beta), ptr(out_v),
                C, G, stream_of(beta))
    name = "seg_logp_grad" if grad else "seg_loglik"
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return (out_v, out_g) if grad else out_v


def logistic_loglik_segment(beta, x, y, layout: SegmentLayout):
    """(C, G) value-only ragged loglik: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if on_cpu(beta, "seg_loglik"):
        return logistic_loglik_segment_plain(beta, x, y, layout)
    return _launch(beta, x, y, layout, grad=False)


def logistic_logp_grad_segment(beta, x, y, layout: SegmentLayout):
    """((C, G) loglik, (C, G, p) grad) over ragged data: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if on_cpu(beta, "seg_logp_grad"):
        return logistic_logp_grad_segment_plain(beta, x, y, layout)
    return _launch(beta, x, y, layout, grad=True)
