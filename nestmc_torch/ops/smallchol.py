"""Unrolled Cholesky algebra for tiny (p <= 8) symmetric matrices.

Port of :mod:`nestmc.ops.smallchol`. Packed layout: a symmetric (or
lower-triangular) p x p matrix is the trailing axis of length
T = p (p + 1) / 2, row-major over the lower triangle: (0,0), (1,0), (1,1),
(2,0), ... Every function broadcasts over leading batch axes. The CUDA
kernels run the same recurrences in registers (csrc/smallchol.cuh).
"""

from __future__ import annotations

import torch


def packed_dim(p: int) -> int:
    return p * (p + 1) // 2


def packed_index(i: int, j: int) -> int:
    """Flat index of entry (i, j) in the packed lower triangle."""
    if j > i:
        i, j = j, i
    return i * (i + 1) // 2 + j


def diag_indices(p: int) -> list:
    return [packed_index(k, k) for k in range(p)]


def pack_dense(a, p: int):
    """(..., p, p) symmetric -> (..., T) packed lower triangle."""
    return torch.stack(
        [a[..., i, j] for i in range(p) for j in range(i + 1)], dim=-1
    )


def unpack_dense(packed, p: int):
    """(..., T) packed -> (..., p, p) full symmetric matrix."""
    rows = [
        torch.stack(
            [packed[..., packed_index(i, j)] for j in range(p)], dim=-1
        )
        for i in range(p)
    ]
    return torch.stack(rows, dim=-2)


def pack_diag(d, p: int):
    """(..., p) diagonal -> (..., T) packed with zero off-diagonals."""
    zero = torch.zeros_like(d[..., 0])
    return torch.stack(
        [d[..., i] if i == j else zero for i in range(p) for j in range(i + 1)],
        dim=-1,
    )


def chol_packed(a, p: int):
    """Cholesky factor L (packed) of a packed SPD matrix. Unrolled Crout,
    no pivoting: a non-PD input yields NaN, which the MH rule rejects."""
    L = [None] * packed_dim(p)
    for j in range(p):
        s = a[..., packed_index(j, j)]
        for k in range(j):
            ljk = L[packed_index(j, k)]
            s = s - ljk * ljk
        L[packed_index(j, j)] = torch.sqrt(s)
        inv_d = 1.0 / L[packed_index(j, j)]
        for i in range(j + 1, p):
            s = a[..., packed_index(i, j)]
            for k in range(j):
                s = s - L[packed_index(i, k)] * L[packed_index(j, k)]
            L[packed_index(i, j)] = s * inv_d
    return torch.stack(L, dim=-1)


def solve_lower(L, b, p: int):
    """y with L y = b (forward substitution), b: (..., p)."""
    y = [None] * p
    for i in range(p):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., packed_index(i, k)] * y[k]
        y[i] = s / L[..., packed_index(i, i)]
    return torch.stack(y, dim=-1)


def solve_upper_t(L, b, p: int):
    """x with L^T x = b (back substitution), b: (..., p)."""
    x = [None] * p
    for i in reversed(range(p)):
        s = b[..., i]
        for k in range(i + 1, p):
            s = s - L[..., packed_index(k, i)] * x[k]
        x[i] = s / L[..., packed_index(i, i)]
    return torch.stack(x, dim=-1)


def spd_solve(L, b, p: int):
    """x with (L L^T) x = b."""
    return solve_upper_t(L, solve_lower(L, b, p), p)


def lt_vec(L, v, p: int):
    """L^T v: ||L^T r||^2 = r^T (L L^T) r."""
    out = []
    for i in range(p):
        s = L[..., packed_index(i, i)] * v[..., i]
        for k in range(i + 1, p):
            s = s + L[..., packed_index(k, i)] * v[..., k]
        out.append(s)
    return torch.stack(out, dim=-1)


def half_logdet(L, p: int):
    """log det(L) = 0.5 log det(L L^T)."""
    s = torch.log(L[..., packed_index(0, 0)])
    for k in range(1, p):
        s = s + torch.log(L[..., packed_index(k, k)])
    return s
