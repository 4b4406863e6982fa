"""Nested-data container: observations within groups, padded + masked.

The padded form of :class:`nestmc.data.NestedData` as tensors on one
device. Ragged/segment data is not ported yet (ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class NestedData:
    """x (G, n, p) covariates, y and mask (G, n), sizes (G,) int32.

    All tensors live on one device; the sampler runs on that device.
    """

    y: torch.Tensor
    mask: torch.Tensor
    sizes: torch.Tensor
    x: torch.Tensor

    @property
    def num_groups(self) -> int:
        return self.y.shape[0]

    @property
    def num_covariates(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.y.device


def check_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (the entry points never fall back to the CPU by themselves)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the kernels' plain versions on the CPU"
        )
    return device


def from_numpy(x, y, mask, device="cuda") -> NestedData:
    """Build padded data from numpy arrays (e.g. the JAX package's), as
    float32 tensors on ``device`` (the card unless the caller asks for
    another)."""
    device = check_device(device)
    mask_np = np.asarray(mask, np.float32)
    sizes = (mask_np > 0.5).sum(axis=1).astype(np.int32)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a, copy=True)).to(
            device=device, dtype=dtype
        )

    return NestedData(
        y=t(np.asarray(y, np.float32)),
        mask=t(mask_np),
        sizes=t(sizes, torch.int32),
        x=t(np.asarray(x, np.float32)),
    )
