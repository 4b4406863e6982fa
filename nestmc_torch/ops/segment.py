"""The static layout of one ragged dataset for the segment kernels.

Counterpart of :class:`nestmc.ops.pallas.loglik_segment.TiledSegmentLayout`.
The reference re-lays the observations out as tiles of groups padded to
whole chunks, with a chunk -> tile map for its sequential grid and a
one-hot gather. The CUDA kernel (csrc/loglik_segment.cu) needs none of
that: one thread block takes one group for a tile of chains and reads the
group's observations straight from the flat arrays through the CSR row
pointer. The layout is that pointer, built once on the host from the
sorted segment ids, plus the ids themselves for the plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nestmc_torch.data import check_device, segment_offsets


@dataclass(frozen=True)
class SegmentLayout:
    """offsets (G+1,) int32 CSR row pointer; segment_ids (N,) int64; both
    on the data's device."""

    offsets: torch.Tensor
    segment_ids: torch.Tensor
    num_groups: int

    @property
    def num_obs(self) -> int:
        return self.segment_ids.shape[0]

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @staticmethod
    def build(segment_ids, num_groups: int, device=None) -> "SegmentLayout":
        """From sorted ``segment_ids`` (a tensor, whose device the layout
        takes, or an array, placed on ``device``, the card by default).
        Raises ValueError on unsorted or out-of-range ids."""
        if torch.is_tensor(segment_ids):
            device = segment_ids.device if device is None else device
            segment_ids = segment_ids.cpu().numpy()
        seg = np.asarray(segment_ids, np.int64)
        offsets = segment_offsets(seg, num_groups)
        device = check_device("cuda" if device is None else device)
        return SegmentLayout(
            offsets=torch.from_numpy(offsets).to(device),
            segment_ids=torch.from_numpy(seg).to(device),
            num_groups=int(num_groups),
        )
