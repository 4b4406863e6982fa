"""The plain reference's parts that every model's reference shares, in plain
PyTorch and numpy (it imports nothing of the program): the program's noise
as its definition gives it, the algebra of small packed symmetric
matrices, TF32 rounding for the control, the key-word generator's count,
and split R-hat.

Noise, as the sampler defines it:
- a fused step's per-cell proposal noise and log-uniforms come from
  Philox-4x32-10 keyed by the launch's two key words, drawn from the run's
  host generator: on the card inside the step (cell (c, g) at counter
  c * G + g, 2p + 1 uniforms from counters (cell, 0) and (cell, 1),
  Box-Muller cos branch on uniform pairs, log of the last), on the CPU
  from two counter-indexed fills (element e of the flat tensor is word
  e & 3 of the call at counter e >> 2; normals Box-Muller on both
  branches), one key each;
- every draw without a unit axis from the run's device generator, at the
  global shape, in the sweep's order (each model's reference draws them).

A model's reference (portbench/models/<model>_reference.py) computes in
float32 with TF32 off (:func:`no_tf32` keeps the library's TF32 off); its
control is the same arithmetic with the inputs of its matrix products
rounded to TF32 (:func:`mm`), the nearest precision below the
configuration's, as a TF32 product takes them.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)
_WEYL = (0x9E3779B9, 0xBB67AE85)


@contextlib.contextmanager
def no_tf32():
    """The library's TF32 matrix products off inside the block (the
    reference's float32 products are float32; its control rounds their
    inputs itself)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---- Philox-4x32-10 ----

def philox(counter: torch.Tensor, k0: int, k1: int) -> tuple:
    """The four output words (int64 holding uint32) at counters (counter
    mod 2^32, counter >> 32, 0, 0), key (k0, k1)."""
    x, y = counter & _M32, (counter >> 32) & _M32
    z, w = torch.zeros_like(counter), torch.zeros_like(counter)
    for r in range(10):
        ka = (k0 + r * _WEYL[0]) & _M32
        kb = (k1 + r * _WEYL[1]) & _M32
        p0 = x * _MUL[0]
        p1 = z * _MUL[1]
        hi0, lo0 = (p0 >> 32) & _M32, p0 & _M32
        hi1, lo1 = (p1 >> 32) & _M32, p1 & _M32
        x, y, z, w = hi1 ^ y ^ ka, lo1, hi0 ^ w ^ kb, lo0
    return x, y, z, w


def _unit(bits):
    """Top 24 bits to (0, 1]: (b >> 8) 2^-24 + 2^-25 rounded once to
    float32, as the kernels convert them; returned in float64 for the
    transcendental functions that follow."""
    return ((bits >> 8).to(torch.float64) * 2.0 ** -24
            + 2.0 ** -25).float().double()


def step_noise_kernel(key, c0: int, C: int, G: int, p: int, device):
    """(eps (C, G, p), log u (C, G)) of chains c0 .. c0 + C - 1 of the
    fused step's in-kernel Philox draws, float32."""
    k0, k1 = (int(v) & _M32 for v in key)
    c = torch.arange(c0, c0 + C, dtype=torch.int64, device=device)
    cell = (c[:, None] * G + torch.arange(G, dtype=torch.int64,
                                          device=device)[None, :])
    uni = []
    for blk in range((2 * p + 1 + 3) // 4):
        uni.extend(_unit(wd) for wd in philox(cell + (blk << 32), k0, k1))
    eps = torch.stack([
        torch.sqrt(-2.0 * torch.log(uni[2 * k]))
        * torch.cos(2.0 * math.pi * uni[2 * k + 1]) for k in range(p)],
        dim=-1)
    logu = torch.log(uni[2 * p])
    return eps.float(), logu.float()


def fill(shape, key, c0: int, mode: str, device):
    """Rows c0 .. of the counter-indexed fill of a (C_total, *rest) tensor:
    element e of the flat tensor takes word e & 3 of the call at counter
    e >> 2; 'normal' (Box-Muller on both branches of each word pair) or
    'log_uniform', float32."""
    k0, k1 = (int(v) & _M32 for v in key)
    rows = int(shape[0])
    K = int(np.prod(shape[1:]))
    e = (c0 * K + torch.arange(rows * K, dtype=torch.int64, device=device))
    q, lane = e >> 2, e & 3
    x, y, z, w = philox(q, k0, k1)
    if mode == "log_uniform":
        words = torch.stack([x, y, z, w])
        out = torch.log(_unit(words.gather(0, lane[None])[0]))
    else:
        first = torch.where(lane < 2, x, z)
        second = torch.where(lane < 2, y, w)
        r = torch.sqrt(-2.0 * torch.log(_unit(first)))
        t = 2.0 * math.pi * _unit(second)
        out = torch.where(lane % 2 == 0, r * torch.cos(t), r * torch.sin(t))
    return out.float().reshape(tuple(shape))


# ---- the Cholesky algebra of small packed matrices ----

def pack_index(i, j):
    if j > i:
        i, j = j, i
    return i * (i + 1) // 2 + j


def pack_diag(d, p):
    zero = torch.zeros_like(d[..., 0])
    return torch.stack([d[..., i] if i == j else zero
                        for i in range(p) for j in range(i + 1)], dim=-1)


def chol(a, p):
    L = [None] * (p * (p + 1) // 2)
    for j in range(p):
        s = a[..., pack_index(j, j)]
        for k in range(j):
            s = s - L[pack_index(j, k)] * L[pack_index(j, k)]
        L[pack_index(j, j)] = torch.sqrt(s)
        inv = 1.0 / L[pack_index(j, j)]
        for i in range(j + 1, p):
            s = a[..., pack_index(i, j)]
            for k in range(j):
                s = s - L[pack_index(i, k)] * L[pack_index(j, k)]
            L[pack_index(i, j)] = s * inv
    return torch.stack(L, dim=-1)


def solve_lower(L, b, p):
    y = [None] * p
    for i in range(p):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., pack_index(i, k)] * y[k]
        y[i] = s / L[..., pack_index(i, i)]
    return torch.stack(y, dim=-1)


def solve_upper_t(L, b, p):
    x = [None] * p
    for i in reversed(range(p)):
        s = b[..., i]
        for k in range(i + 1, p):
            s = s - L[..., pack_index(k, i)] * x[k]
        x[i] = s / L[..., pack_index(i, i)]
    return torch.stack(x, dim=-1)


def spd_solve(L, b, p):
    return solve_upper_t(L, solve_lower(L, b, p), p)


def lt_vec(L, v, p):
    out = []
    for i in range(p):
        s = L[..., pack_index(i, i)] * v[..., i]
        for k in range(i + 1, p):
            s = s + L[..., pack_index(k, i)] * v[..., k]
        out.append(s)
    return torch.stack(out, dim=-1)


def half_logdet(L, p):
    s = torch.log(L[..., 0])
    for k in range(1, p):
        s = s + torch.log(L[..., pack_index(k, k)])
    return s


# ---- the Bernoulli-logit observations ----

def accept_prob(log_alpha):
    """min(1, exp(log alpha)), NaN -> 0: the acceptance probability the
    Robbins-Monro update reads."""
    a = torch.exp(log_alpha.clamp_max(0.0))
    return torch.where(torch.isnan(log_alpha), torch.zeros_like(a), a)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away
    from zero), as a TF32 matrix product rounds its inputs."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(eq, a, b, tf32):
    """torch.einsum(eq, a, b), with TF32 inputs when ``tf32``."""
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return torch.einsum(eq, a, b)


def chain_blocks(C: int, G: int, n: int, budget: int = 1 << 25):
    """Chain slices whose (chains, G, n) temporaries hold ``budget``
    elements at most."""
    step = max(1, budget // max(1, G * n))
    return [(c, min(C, c + step)) for c in range(0, C, step)]


def advance_keys(host_state, sweeps: int, keys: int) -> torch.Tensor:
    """The key-word generator's state after ``sweeps`` sweeps that each
    take ``keys`` pairs of words, from ``host_state``."""
    host = torch.Generator()
    host.set_state(host_state)
    for _ in range(sweeps):
        torch.randint(0, 2 ** 32, (keys, 2), generator=host,
                      dtype=torch.int64)
    return host.get_state()


# ---- split R-hat of collected draws ----

def split_rhat(draws: torch.Tensor, rthin: int) -> torch.Tensor:
    """Classic split R-hat of the draws the streamed accumulators fold:
    every rthin-th retained draw, the first 2 * half of them split in two
    halves; float64. draws (C, D, ...) -> (...)."""
    x = draws[:, ::rthin].double()
    half = x.shape[1] // 2
    x = x[:, :2 * half]
    seqs = torch.cat([x[:, :half], x[:, half:]])
    w = torch.var(seqs, dim=1, correction=1).mean(0)
    b = half * torch.var(seqs.mean(1), dim=0, correction=1)
    var_plus = (half - 1.0) / half * w + b / half
    return torch.sqrt(var_plus / torch.where(w > 0, w, torch.ones_like(w)))


def split_rhat_tf32(draws: torch.Tensor, rthin: int) -> torch.Tensor:
    """The control of the streamed accumulators: the same split R-hat from
    Welford accumulators held in TF32 (each running mean and sum of squares
    rounded to a 10-bit mantissa after every update)."""
    x = draws[:, ::rthin].float()
    half = x.shape[1] // 2
    seqs = torch.cat([x[:, :half], x[:, half:2 * half]])
    mean = torch.zeros_like(seqs[:, 0])
    m2 = torch.zeros_like(seqs[:, 0])
    for t in range(half):
        xt = seqs[:, t]
        delta = xt - mean
        mean = tf32_round(mean + delta / (t + 1))
        m2 = tf32_round(m2 + delta * (xt - mean))
    n = float(half)
    w = (m2 / max(n - 1.0, 1.0)).double().mean(0)
    b = n * torch.var(mean.double(), dim=0, correction=1)
    var_plus = (n - 1.0) / n * w + b / n
    return torch.sqrt(var_plus / torch.where(w > 0, w, torch.ones_like(w)))