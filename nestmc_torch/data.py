"""Nested-data containers: observations within groups, padded + masked.

The padded form of :class:`nestmc.data.NestedData` and the three-level
:class:`nestmc.data.NestedData3` as tensors on one device. Ragged/segment
data is not ported yet (ROADMAP Queue 1, item 10).
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


def _tensor(a, device, dtype=torch.float32):
    return torch.from_numpy(np.array(a, copy=True)).to(
        device=device, dtype=dtype
    )


def from_numpy(x, y, mask, device="cuda") -> NestedData:
    """Build padded data from numpy arrays (e.g. the JAX package's), as
    float32 tensors on ``device`` (the card unless the caller asks for
    another)."""
    device = check_device(device)
    mask_np = np.asarray(mask, np.float32)
    sizes = (mask_np > 0.5).sum(axis=1).astype(np.int32)
    return NestedData(
        y=_tensor(np.asarray(y, np.float32), device),
        mask=_tensor(mask_np, device),
        sizes=_tensor(sizes, device, torch.int32),
        x=_tensor(np.asarray(x, np.float32), device),
    )


@dataclass(frozen=True)
class NestedData3:
    """Three-level data: observations within subjects within groups.

    x (S, n, p) covariates, y and mask (S, n) padded per subject;
    subject_group (S,) int64, sorted, the group of each subject; num_groups
    G. Built once by :func:`from_numpy3`, which also derives what the
    subject -> group reductions need:

    - subject_counts (G,) float32, subjects per group;
    - members (G, M) int64, the subjects of each group in order (M the
      largest group), padded with 0, and member_mask (G, M) float32, or
      both None when every group holds M consecutive subjects (then a
      reshape replaces the gather).

    Segment sums over subjects (:meth:`group_sum`) are a gather and a sum
    over the M axis, so they are deterministic, unlike atomic scatters.
    """

    y: torch.Tensor
    mask: torch.Tensor
    subject_group: torch.Tensor
    num_groups: int
    x: torch.Tensor
    subject_counts: torch.Tensor
    members: torch.Tensor | None
    member_mask: torch.Tensor | None
    group_size: int

    @property
    def num_subjects(self) -> int:
        return self.y.shape[0]

    @property
    def num_covariates(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.y.device

    def to_subjects(self, arr_g: torch.Tensor) -> torch.Tensor:
        """(C, G, ...) -> (C, S, ...): each subject's group's row."""
        return arr_g.index_select(1, self.subject_group)

    def group_sum(self, arr_s: torch.Tensor) -> torch.Tensor:
        """(C, S, ...) -> (C, G, ...): the sum over each group's subjects,
        in subject order."""
        C, G = arr_s.shape[0], self.num_groups
        rest = tuple(arr_s.shape[2:])
        if self.members is None:
            return arr_s.reshape((C, G, self.group_size) + rest).sum(dim=2)
        g = arr_s.index_select(1, self.members.reshape(-1)).reshape(
            (C, G, self.group_size) + rest
        )
        m = self.member_mask.reshape((1, G, self.group_size)
                                     + (1,) * len(rest))
        return (g * m).sum(dim=2)


def from_numpy3(x, y, mask, subject_group, num_groups: int,
                device="cuda") -> NestedData3:
    """Build three-level data from numpy arrays (e.g. the JAX package's
    NestedData3 leaves) on ``device`` (the card unless the caller asks for
    another). ``subject_group`` must be sorted, every id in [0,
    num_groups)."""
    device = check_device(device)
    sg = np.asarray(subject_group, np.int64)
    G = int(num_groups)
    if sg.ndim != 1 or np.any(np.diff(sg) < 0):
        raise ValueError("subject_group must be a sorted (S,) array")
    if sg.shape[0] != np.shape(y)[0]:
        raise ValueError(f"subject_group has {sg.shape[0]} subjects, y "
                         f"{np.shape(y)[0]}")
    if sg.size and (sg[0] < 0 or sg[-1] >= G):
        raise ValueError(f"subject_group ids must lie in [0, {G})")
    counts = np.bincount(sg, minlength=G)
    M = max(int(counts.max()) if G else 0, 1)
    members = member_mask = None
    if not np.all(counts == M):
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        j = np.arange(M)[None, :]
        member_mask = (j < counts[:, None]).astype(np.float32)
        members = np.where(member_mask > 0, starts[:, None] + j, 0)
        members = _tensor(members, device, torch.int64)
        member_mask = _tensor(member_mask, device)
    return NestedData3(
        y=_tensor(np.asarray(y, np.float32), device),
        mask=_tensor(np.asarray(mask, np.float32), device),
        subject_group=_tensor(sg, device, torch.int64),
        num_groups=G,
        x=_tensor(np.asarray(x, np.float32), device),
        subject_counts=_tensor(counts.astype(np.float32), device),
        members=members,
        member_mask=member_mask,
        group_size=M,
    )
