"""Nested-data containers: observations within groups.

The padded form of :class:`nestmc.data.NestedData`, the flat segment form
of :class:`nestmc.data.RaggedData` and the three-level
:class:`nestmc.data.NestedData3`, as tensors on one device, plus
:func:`bucket_by_size` (groups padded per power-of-2 size bucket).
Each is built from numpy arrays (``from_numpy``, ``from_numpy_ragged``,
``from_numpy3``) or from per-group lists (the ``from_ragged`` static
methods, which go through those functions).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

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
    def max_obs(self) -> int:
        return self.y.shape[1]

    @property
    def num_covariates(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.y.device

    @staticmethod
    def from_ragged(ys: Sequence, xs: Sequence | None = None,
                    max_obs: int | None = None, extra: dict | None = None,
                    device="cuda") -> "NestedData":
        """Padded data from per-group lists: ``ys[g]`` (n_g,) and ``xs[g]``
        (n_g, p) are group g's observations, padded to ``max_obs`` (the
        largest group unless given; longer groups are cut to it while
        ``sizes`` keeps their true lengths, as the reference's). No ``xs``
        gives an empty (G, n, 0) x."""
        y, x, mask, sizes = _pad_lists(ys, xs, max_obs)
        data = from_numpy(x, y, mask, device=device, extra=extra)
        return dataclasses.replace(
            data, sizes=_tensor(sizes, data.device, torch.int32))

    def to_ragged(self) -> "RaggedData":
        """The flat segment form (the padded slots dropped): sorted int64
        segment_ids and their CSR offsets, on this data's device."""
        mask = self.mask.cpu().numpy() > 0.5
        seg = np.broadcast_to(
            np.arange(self.num_groups, dtype=np.int64)[:, None], mask.shape
        )[mask]
        data = from_numpy_ragged(self.x.cpu().numpy()[mask],
                                 self.y.cpu().numpy()[mask], seg,
                                 self.num_groups, device=self.device)
        return dataclasses.replace(data, extra=dict(self.extra))

    def pad_groups_to(self, G_pad: int) -> "NestedData":
        """The group axis padded to ``G_pad`` with empty groups (mask and
        sizes 0), every ``extra`` leaf padded the same way. An empty group
        adds exactly 0 to every obs pass; its group-level parameters
        sample from the prior."""
        G = self.num_groups
        if G_pad == G:
            return self
        if G_pad < G:
            raise ValueError(f"G_pad={G_pad} < num_groups={G}")

        def padg(a):
            z = a.new_zeros((G_pad - G,) + tuple(a.shape[1:]))
            return torch.cat([a, z], dim=0)

        return NestedData(
            y=padg(self.y), mask=padg(self.mask), sizes=padg(self.sizes),
            x=padg(self.x),
            extra={k: padg(v) for k, v in self.extra.items()},
        )


def memo_by_data(fn, data):
    """d -> fn(d), computed once for the build-time ``data`` and once for
    the last other data object a hook saw (a group shard's local data,
    which stays the same object for a whole run; each new data set of
    the Geweke tier): a model's parameter-free per-data terms."""
    built = fn(data)
    last = {}

    def get(d):
        if d is data:
            return built
        if last.get("d") is not d:
            last.update(d=d, v=fn(d))
        return last["v"]

    return get


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


def _extra_tensors(extra, device) -> dict:
    """{name: array} -> {name: float32 tensor on ``device``}."""
    return {k: _tensor(np.asarray(v, np.float32), device)
            for k, v in (extra or {}).items()}


def _pad_lists(ys, xs, max_obs):
    """Per-group lists -> padded float32 (y (G, n), x (G, n, p) or None,
    mask (G, n), sizes (G,) int32 of the lists' lengths), n = max_obs or
    the longest list. y and x are staged in float64 and cast to float32
    once, as the reference's from_ragged does, so the bits match."""
    G = len(ys)
    sizes = np.array([len(y) for y in ys], dtype=np.int32)
    n = int(max_obs if max_obs is not None else (sizes.max() if G else 0))
    y = np.zeros((G, n), np.float64)
    mask = np.zeros((G, n), np.float32)
    for g, yg in enumerate(ys):
        k = min(len(yg), n)
        y[g, :k] = np.asarray(yg)[:k]
        mask[g, :k] = 1.0
    x = None
    if xs is not None:
        p = int(np.asarray(xs[0]).shape[-1]) if G else 0
        x = np.zeros((G, n, p), np.float64)
        for g, xg in enumerate(xs):
            k = min(len(xg), n)
            x[g, :k] = np.asarray(xg)[:k]
        x = x.astype(np.float32)
    return y.astype(np.float32), x, mask, sizes


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
        extra=_extra_tensors(extra, device),
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
    ``extra`` {name: tensor} carries further arrays, as NestedData's.
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
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def num_subjects(self) -> int:
        return self.y.shape[0]

    @property
    def max_obs(self) -> int:
        return self.y.shape[1]

    @property
    def num_covariates(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.y.device

    @staticmethod
    def from_ragged(ys: Sequence, xs: Sequence | None = None,
                    extra: dict | None = None,
                    device="cuda") -> "NestedData3":
        """Three-level data from nested lists: ``ys[g][s]`` (and ``xs[g][s]``)
        are the observations of subject s of group g, padded per subject
        to the longest (:meth:`NestedData.from_ragged`), then built by
        :func:`from_numpy3`."""
        flat_y, flat_x, subj_grp = [], [], []
        for g, group in enumerate(ys):
            for s, yarr in enumerate(group):
                flat_y.append(yarr)
                subj_grp.append(g)
                if xs is not None:
                    flat_x.append(xs[g][s])
        y, x, mask, _ = _pad_lists(flat_y, flat_x if xs is not None
                                   else None, None)
        if x is None:
            x = np.zeros(mask.shape + (0,), np.float32)
        data = from_numpy3(x, y, mask, np.array(subj_grp, np.int64),
                           len(ys), device=device)
        return dataclasses.replace(data,
                                   extra=_extra_tensors(extra, data.device))

    def subset_groups(self, g0: int, g1: int) -> "NestedData3":
        """Groups g0 .. g1 - 1 and their subjects (a group shard's data):
        group ids shifted to start at 0, members rebuilt for the subset,
        each ``extra`` leaf cut on its subject or group axis."""
        sg = self.subject_group.cpu().numpy()
        s0, s1 = (int(i) for i in np.searchsorted(sg, [g0, g1]))
        out = from_numpy3(self.x[s0:s1].cpu().numpy(),
                          self.y[s0:s1].cpu().numpy(),
                          self.mask[s0:s1].cpu().numpy(), sg[s0:s1] - g0,
                          g1 - g0, device=self.device)
        S, G = self.num_subjects, self.num_groups

        def cut(v):
            if v.shape[:1] == (S,):
                return v[s0:s1]
            return v[g0:g1] if v.shape[:1] == (G,) else v

        return dataclasses.replace(
            out, extra={k: cut(v) for k, v in self.extra.items()})

    def subjects_per_group(self) -> torch.Tensor:
        """(G,) int32 subjects of each group (from subject_counts: no
        scatter)."""
        return self.subject_counts.to(torch.int32)

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
    offsets[g] .. offsets[g+1] - 1. ``extra`` {name: tensor} carries
    further arrays, as NestedData's.
    """

    y: torch.Tensor
    segment_ids: torch.Tensor
    num_groups: int
    x: torch.Tensor
    offsets: torch.Tensor
    extra: dict = dataclasses.field(default_factory=dict)

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

    @staticmethod
    def from_ragged(ys: Sequence, xs: Sequence | None = None,
                    extra: dict | None = None,
                    device="cuda") -> "RaggedData":
        """Flat data from per-group lists (``ys[g]`` (n_g,), ``xs[g]``
        (n_g, p)), built by :func:`from_numpy_ragged`; no ``xs`` gives an
        empty (N, 0) x. ``extra`` {name: array} is carried as float32
        tensors."""
        seg = (np.concatenate([np.full(len(y), g, np.int64)
                               for g, y in enumerate(ys)])
               if len(ys) else np.zeros((0,), np.int64))
        y = (np.concatenate([np.asarray(y) for y in ys]) if len(ys)
             else np.zeros((0,)))
        x = (np.concatenate([np.asarray(xg) for xg in xs], axis=0)
             if xs is not None and len(xs)
             else np.zeros((len(y), 0), np.float32))
        data = from_numpy_ragged(x, y, seg, len(ys), device=device)
        return dataclasses.replace(data,
                                   extra=_extra_tensors(extra, data.device))


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
