"""The counter-indexed noise fill on the card (csrc/philox_fill.cu).

A draw whose tensor has a unit axis, shape (C, U, *rest) in the unsharded
run, is filled from Philox-4x32-10 keyed by one pair of key words (a
launch's, SweepRNG.key_words), four elements a call. Element g of the
unsharded tensor (its row-major index) belongs to call q = g >> 2, at
counter (q mod 2^32, q >> 32, 0, 0), and takes output word g & 3 of it.
A rank that holds chains c0.. of its block and units u0.. of U fills only
its (chain span x unit span) block, with the unsharded run's values: an
element's value depends on g and the key alone. Modes: "words" (the
element's word, as int32 bits), "uniform" (its top 24 bits, offset off
zero: csrc/philox.cuh::bits_to_unit), "log_uniform" (their log) and
"normal" (Box-Muller on both branches: lanes 0 and 1 are r cos(2 pi u2)
and r sin(2 pi u2) with u1, u2 the uniforms of words 0 and 1 and r =
sqrt(-2 log u1); lanes 2 and 3 the same on words 2 and 3), the in-kernel
draws' conversions.

:func:`philox_fill` launches the kernel for a CUDA device and runs
:func:`philox_fill_plain` (integer Philox on int64 tensors, one call a quad
of elements that the block touches) for the CPU. The plain version's words
and uniforms are the kernel's bit for bit; its normals and logs are
computed in float64 and rounded once, so the kernel's (float32 logf,
sqrtf, sincospif) lie within a few ulps of them.
"""

from __future__ import annotations

import math

import torch

from nestmc_torch.ops.cuda import LAUNCHES, _build, costed
from nestmc_torch.ops.cuda.common import ptr, stream_of

MODES = {"words": 0, "uniform": 1, "log_uniform": 2, "normal": 3}
# float32 operations of an element's conversion (the cost model's n): the
# uniform's scale and offset; its log; a normal pair's two uniforms, one
# log, its -2 scaling, one square root, 2 u2, one sincospi (two values)
# and two products: 12 a pair
FLOAT_OPS = {"words": 0, "uniform": 2, "log_uniform": 3, "normal": 6}
_M32 = 0xFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)
_WEYL = (0x9E3779B9, 0xBB67AE85)


def block_layout(shape, c0: int, u0: int, U: int) -> tuple:
    """(rows, len, base, stride) of a block of shape (C, Ul, *rest) that
    holds chains c0.. and units u0.. of an unsharded (*, U, *rest) tensor:
    element (r, j) of the block viewed as (rows, len) is element base + r
    * stride + j of the unsharded tensor."""
    rows = int(shape[0])
    K = math.prod(int(s) for s in shape[2:])
    return (rows, int(shape[1]) * K, (int(c0) * U + int(u0)) * K, U * K)


def _describe(a):
    rows, n, _, _ = block_layout(a["shape"], a["c0"], a["u0"], a["U"])
    return ("philox_fill", rows, n, FLOAT_OPS[a["mode"]], 1, False, False)


def philox_words(counter: torch.Tensor, k0: int, k1: int) -> tuple:
    """(x, y, z, w): the four output words (int64 tensors holding uint32
    values) of Philox-4x32-10 at counters (counter mod 2^32, counter div
    2^32, 0, 0), key (k0, k1); csrc/philox.cuh::philox4x32_10."""
    # (x, z) and (y, w) as the rows of two tensors: one multiply a round;
    # the int64 product wraps past 2^63, its low 64 bits stay exact
    dev = counter.device
    xz = torch.stack([counter & _M32, torch.zeros_like(counter)])
    yw = torch.stack([(counter >> 32) & _M32, torch.zeros_like(counter)])
    mul = torch.tensor(_MUL, dtype=torch.int64, device=dev).reshape(2, 1)
    keys = torch.tensor([[(k0 + r * _WEYL[0]) & _M32,
                          (k1 + r * _WEYL[1]) & _M32] for r in range(10)],
                        dtype=torch.int64, device=dev).reshape(10, 2, 1)
    for r in range(10):
        lo = xz * mul
        hi = lo >> 32
        hi &= _M32                  # (hi0, hi1)
        lo &= _M32                  # (lo0, lo1)
        xz = hi.flip(0)             # x = hi1 ^ y ^ k0, z = hi0 ^ w ^ k1
        xz ^= yw
        xz ^= keys[r]
        yw = lo.flip(0)             # y = lo1, w = lo0
    return xz[0], yw[0], xz[1], yw[1]


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """bits_to_unit: (b >> 8) 2^-24 + 2^-25, one rounding to float32."""
    return ((bits >> 8).to(torch.float64) * 2.0 ** -24
            + 2.0 ** -25).to(torch.float32)


def philox_fill_plain(shape, key, c0: int, u0: int, U: int, mode: str,
                      device="cpu") -> torch.Tensor:
    """The fill of a (C, Ul, *rest) block (see the module), computed with
    PyTorch's integer ops on ``device``: the CPU wherever the port runs
    it; the card only to hold the kernel against it."""
    if mode not in MODES:
        raise ValueError(f"philox_fill: unknown mode {mode!r}")
    rows, n, base, stride = block_layout(shape, c0, u0, U)
    dtype = torch.int32 if mode == "words" else torch.float32
    if rows * n == 0:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    k0, k1 = (int(w) & _M32 for w in key.tolist())
    # row r's elements g = gs + j, j < n, are lanes (gs & 3) + j of the
    # quads from gs >> 2 on, laid end to end. Every tensor is flat or
    # shaped like the block (a (rows, n) tensor would be one of the
    # unsharded run's extents for some blocks)
    gs = base + torch.arange(rows, dtype=torch.int64, device=device) * stride
    lead = gs & 3
    nq = (int(lead.max()) + n + 3) // 4
    i = torch.arange(rows * nq, dtype=torch.int64, device=device)
    x, y, z, w = philox_words((gs >> 2).repeat_interleave(nq) + i % nq,
                              k0, k1)
    lanes = torch.empty(4 * rows * nq, dtype=dtype, device=device)
    if mode == "words":
        for at, v in enumerate((x, y, z, w)):
            lanes[at::4] = torch.where(v >= 2 ** 31, v - 2 ** 32, v)
    elif mode == "uniform":
        for at, v in enumerate((x, y, z, w)):
            lanes[at::4] = _unit(v)
    elif mode == "log_uniform":
        for at, v in enumerate((x, y, z, w)):
            lanes[at::4] = torch.log(_unit(v).to(torch.float64))
    else:
        for at, (a, b) in ((0, (x, y)), (2, (z, w))):
            r = torch.sqrt(-2.0 * torch.log(_unit(a).to(torch.float64)))
            t = 2.0 * math.pi * _unit(b).to(torch.float64)
            lanes[at::4] = r * torch.cos(t)
            lanes[at + 1::4] = r * torch.sin(t)
    start = torch.arange(rows, dtype=torch.int64, device=device) * (4 * nq)
    idx = ((start + lead).reshape((-1,) + (1,) * (len(shape) - 1))
           + torch.arange(n, dtype=torch.int64,
                          device=device).reshape((1,) + tuple(shape[1:])))
    return lanes[idx]


@costed(_describe)
def philox_fill(shape, key: torch.Tensor, c0: int, u0: int, U: int,
                mode: str, device) -> torch.Tensor:
    """The (C, Ul, *rest) block, on ``device``, of the fill keyed by
    ``key`` (the two words, a (2,) int32 tensor on ``device``), holding
    chains c0.. and units u0.. of U; float32, or int32 in words mode."""
    device = torch.device(device)
    if mode not in MODES:
        raise ValueError(f"philox_fill: unknown mode {mode!r}")
    if device.type == "cpu":
        return philox_fill_plain(shape, key, c0, u0, U, mode)
    if device.type != "cuda":
        raise RuntimeError(f"philox_fill: no kernel for device {device}")
    if (key.device.type != "cuda" or key.dtype != torch.int32
            or key.numel() != 2 or device.index not in (None,
                                                        key.device.index)):
        raise ValueError("philox_fill: key must be two int32 words on "
                         f"{device}")
    device = key.device
    rows, n, base, stride = block_layout(shape, c0, u0, U)
    lib = _build.shared_library()
    dtype = torch.int32 if mode == "words" else torch.float32
    with torch.cuda.device(device):
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        rc = lib.nestmc_philox_fill(ptr(out), rows, n, base, stride,
                                    ptr(key.contiguous()), MODES[mode],
                                    stream_of(out))
    _build.check(rc, "philox_fill")
    LAUNCHES["philox_fill"] += 1
    return out
