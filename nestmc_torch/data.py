"""Nested-data containers: observations within groups.

The padded form of :class:`nestmc.data.NestedData`, the flat segment form
of :class:`nestmc.data.RaggedData` and the three-level
:class:`nestmc.data.NestedData3`, as tensors on one device, plus
:func:`bucket_by_size` (groups padded per power-of-2 size bucket).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class NestedData:
    """x (G, n, p) covariates (p = 0 for models without covariates), y and
    mask (G, n), sizes (G,) int32, extra {name: tensor} of further
    per-group or per-obs arrays (e.g. the eight-schools model's known
    scales).

    All tensors live on one device; the sampler runs on that device.
    """

    y: torch.Tensor
    mask: torch.Tensor
    sizes: torch.Tensor
    x: torch.Tensor
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def num_groups(self) -> int:
        return self.y.shape[0]

    @property
    def num_covariates(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.y.device


def data_device(data) -> torch.device:
    """The device ``data`` lives on: its ``device`` attribute where it has
    one, else that of the first tensor among a dict's values (data are
    opaque to the sampler, e.g. a plain {"y": (C, G, n)} dict)."""
    dev = _find_device(data)
    if dev is None:
        raise ValueError(f"no tensor in the data: {type(data).__name__}")
    return dev


def _find_device(obj):
    dev = getattr(obj, "device", None)
    if isinstance(dev, torch.device):
        return dev
    for item in obj.values() if isinstance(obj, dict) else ():
        dev = _find_device(item)
        if dev is not None:
            return dev
    return None


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


def from_numpy(x, y, mask, device="cuda", extra=None) -> NestedData:
    """Build padded data from numpy arrays (e.g. the JAX package's), as
    float32 tensors on ``device`` (the card unless the caller asks for
    another). ``x`` None gives a model without covariates an empty
    (G, n, 0) x; ``extra`` {name: array} is carried as float32 tensors."""
    device = check_device(device)
    mask_np = np.asarray(mask, np.float32)
    sizes = (mask_np > 0.5).sum(axis=1).astype(np.int32)
    if x is None:
        x = np.zeros(mask_np.shape + (0,), np.float32)
    return NestedData(
        y=_tensor(np.asarray(y, np.float32), device),
        mask=_tensor(mask_np, device),
        sizes=_tensor(sizes, device, torch.int32),
        x=_tensor(np.asarray(x, np.float32), device),
        extra={k: _tensor(np.asarray(v, np.float32), device)
               for k, v in (extra or {}).items()},
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


@dataclass(frozen=True)
class RaggedData:
    """Two-level data in flat segment form: y (N,), x (N, p), segment_ids
    (N,) int64 sorted ascending (each observation's group), num_groups G.

    Built by :func:`from_numpy_ragged`, which also derives the CSR row
    pointer ``offsets`` (G+1,) int32: group g's observations are rows
    offsets[g] .. offsets[g+1] - 1.
    """

    y: torch.Tensor
    segment_ids: torch.Tensor
    num_groups: int
    x: torch.Tensor
    offsets: torch.Tensor

    @property
    def num_obs(self) -> int:
        return self.y.shape[0]

    @property
    def num_covariates(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.y.device

    def sizes(self) -> torch.Tensor:
        """(G,) int32 observations per group."""
        return torch.diff(self.offsets)


def segment_offsets(segment_ids, num_groups: int) -> np.ndarray:
    """The (G+1,) int32 CSR row pointer of sorted ``segment_ids``; raises
    on unsorted ids or ids outside [0, num_groups)."""
    seg = np.asarray(segment_ids, np.int64)
    G = int(num_groups)
    if seg.ndim != 1 or np.any(np.diff(seg) < 0):
        raise ValueError("segment_ids must be a sorted (N,) array")
    if seg.size and (seg[0] < 0 or seg[-1] >= G):
        raise ValueError(f"segment_ids must lie in [0, {G})")
    return np.searchsorted(seg, np.arange(G + 1)).astype(np.int32)


def from_numpy_ragged(x, y, segment_ids, num_groups: int,
                      device="cuda") -> RaggedData:
    """Build flat ragged data from numpy arrays (e.g. the JAX package's
    RaggedData leaves) on ``device`` (the card unless the caller asks for
    another). ``segment_ids`` must be sorted, every id in [0,
    num_groups)."""
    device = check_device(device)
    seg = np.asarray(segment_ids, np.int64)
    if seg.shape[0] != np.shape(y)[0] or np.shape(x)[0] != seg.shape[0]:
        raise ValueError(f"segment_ids has {seg.shape[0]} observations, y "
                         f"{np.shape(y)[0]}, x {np.shape(x)[0]}")
    offsets = segment_offsets(seg, num_groups)
    return RaggedData(
        y=_tensor(np.asarray(y, np.float32), device),
        segment_ids=_tensor(seg, device, torch.int64),
        num_groups=int(num_groups),
        x=_tensor(np.asarray(x, np.float32), device),
        offsets=_tensor(offsets, device, torch.int32),
    )


def bucket_by_size(ys, xs=None, bucket_edges=None, device="cuda"):
    """Split ragged groups into size buckets, each padded to its own cap
    (port of :func:`nestmc.data.bucket_by_size`): ``ys[g]`` (n_g,) and
    ``xs[g]`` (n_g, p) are group g's observations. Power-of-2 edges unless
    ``bucket_edges`` is given; a group of size s goes to the first edge >=
    s, empty groups to none. Returns ``[(NestedData, group_index), ...]``,
    group_index an int64 tensor of the bucket's original group ids; without
    ``xs`` the buckets' x is (Gb, cap, 0)."""
    device = check_device(device)
    sizes = np.array([len(y) for y in ys])
    if bucket_edges is None:
        cap = int(sizes.max()) if len(sizes) else 1
        bucket_edges, e = [], 1
        while e < cap:
            e *= 2
            bucket_edges.append(e)
    p = np.shape(xs[0])[-1] if xs is not None and len(xs) else 0
    out = []
    lo = 0
    for hi in bucket_edges:
        idx = np.where((sizes > lo) & (sizes <= hi))[0]
        lo = hi
        if not len(idx):
            continue
        x = np.zeros((len(idx), hi, p), np.float32)
        y = np.zeros((len(idx), hi), np.float32)
        mask = np.zeros((len(idx), hi), np.float32)
        for r, g in enumerate(idx):
            n = sizes[g]
            y[r, :n] = ys[g]
            mask[r, :n] = 1.0
            if xs is not None:
                x[r, :n] = xs[g]
        out.append((from_numpy(x, y, mask, device=device),
                    _tensor(idx, device, torch.int64)))
    return out
