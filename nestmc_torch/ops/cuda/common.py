"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

from nestmc_torch.rng import words_i32


def on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain path), False for CUDA (kernel path);
    any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise RuntimeError(f"{name}: no kernel for device {t.device}")


def check_tensor(t, name: str, shape: tuple, device) -> None:
    """float32, on ``device``, C-contiguous, of exactly ``shape``."""
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def step_noise(rng, shape, units=None):
    """(eps, log u) of a step's plain version from ``rng``: eps of ``shape``
    (C, U, p), then log u (C, U), each a unit-axis draw (the fill: one key
    pair each); ``units`` as in :func:`cell_offsets`."""
    u = (1, 0, None) if units is None else (1, *units)
    return (rng.normal(shape, units=u),
            rng.log_uniform(tuple(shape[:2]), units=u))


def skip_step(rng, device, shape, units) -> None:
    """Draw the noise of a step launch that a group shard skips because it
    holds none of the launch's units (an empty size bucket on this shard,
    ops/bucket.py): the Philox key on the card (SweepRNG.skip_key), the
    plain version's step_noise on the CPU (two fills of no element, which
    take their key pairs and write nothing). Every rank
    then draws the same a sweep, and the generators, and with them the
    replicated blocks, stay equal across ranks. ``shape`` (C, 0, p)."""
    if torch.device(device).type == "cuda":
        getattr(rng, "skip_key", rng.philox_key)()
    else:
        step_noise(rng, shape, units)


def launch_key(rng, device) -> torch.Tensor:
    """The two Philox key words of a step launch without external noise, as
    the (2,) int32 device tensor the kernel reads: ``rng.key_words`` (a
    SweepRNG: drawn now, or the captured sweep's next pair), else the
    words of ``rng.philox_key()`` (a fixed key of the tests and A/Bs)
    copied to the device."""
    key_words = getattr(rng, "key_words", None)
    if key_words is not None:
        return key_words(device)
    words = torch.tensor(rng.philox_key(), dtype=torch.int64)
    return words_i32(words).to(device)


def cell_offsets(rng, units, U: int) -> tuple:
    """(c0, u0, U_total) of a step launch's Philox counters, (c0 + c) *
    U_total + u0 + u: the index cell (c, u) has in the unsharded launch.
    c0 is the rng's first chain (``rng.chains``, None when it holds every
    chain); ``units`` (u0, U_total) places the launch's U units, None for
    all of them."""
    chains = getattr(rng, "chains", None)
    u0, total = (0, U) if units is None else units
    return (0 if chains is None else int(chains[0])), int(u0), int(total)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# The tile of every kernel (csrc/cell_tile.cuh): chains a tile, units a tile
# at most, an SM's shared memory (H100: 228 KB, 1 KB reserved a block) and
# the most one block may take.
TILE_C = 32
TILE_G_MAX = 32
SMEM_SM = 233_472
SMEM_RESERVED = 1024
SMEM_MAX = 232_448
# launch modes of the tiled kernels, in the order of csrc/tile_plan.cu, with
# the blocks an SM each is built for (its __launch_bounds__); "loglik" is
# the value-only pass of both families
TILE_KINDS = ("logp_grad", "logp_grad_hess", "mala", "mala_noise",
              "pois_mala", "pois_mala_noise", "newton", "newton_noise",
              "pois_newton", "pois_newton_noise", "seg", "rwmh",
              "rwmh_noise", "pois_rwmh", "pois_rwmh_noise", "loglik")
TILE_BLOCKS = {"logp_grad": 5, "logp_grad_hess": 4, "mala": 4,
               "mala_noise": 4, "pois_mala": 4, "pois_mala_noise": 4,
               "newton": 3, "newton_noise": 3, "pois_newton": 3,
               "pois_newton_noise": 3, "seg": 5, "rwmh": 4,
               "rwmh_noise": 4, "pois_rwmh": 4, "pois_rwmh_noise": 4,
               "loglik": 12}
# observations a group of a chunk of the segment kernel's tile (its "n",
# csrc/segment_kernel.cuh::kSegObs)
SEG_OBS = 32


def _tile_widths(kind: str, p: int) -> tuple:
    """Floats a unit of each row buffer (one row a chain): for logp_grad
    the gradient and the loglik (and the packed Hessian) on their way out,
    for the value-only loglik the loglik; for the RW-MH step beta, the
    carried loglik, log_scale, for the MALA step beta, g, v, log_scale, for
    the Newton step beta, g, the packed h, v, log_scale (then eps and log u
    with external noise, then the per-unit prior mean of the Poisson
    steps); for the segment kernel the gradient and the loglik on their way
    out."""
    T = p * (p + 1) // 2
    if kind == "logp_grad":
        return (p, 1)
    if kind == "logp_grad_hess":
        return (p, 1, T)
    if kind == "seg":
        return (p, 1)
    if kind == "loglik":
        return (1,)
    if "rwmh" in kind:
        w = (p, 1, 1)
    elif "newton" in kind:
        w = (p, p, T, 1, 1)
    else:
        w = (p, p, 1, 1)
    if kind.endswith("_noise"):
        w += (p, 1)
    if kind.startswith("pois_"):
        w += (p,)
    return w


def tile_bytes(kind: str, n: int, p: int, tg: int) -> int:
    """Dynamic shared memory of a tile of ``tg`` units: x, y and mask (the
    segment kernel: x and y), each from a 16-byte boundary, and TILE_C rows
    of odd stride (tg w) | 1 for each staged operand of width w."""
    def r4(k):
        return (k + 3) // 4 * 4

    streams = 1 if kind == "seg" else 2
    floats = r4(tg * n * p) + streams * r4(tg * n) + sum(
        TILE_C * ((tg * w) | 1) for w in _tile_widths(kind, p))
    return 4 * floats


def tile_plan(kind: str, n: int, p: int) -> tuple:
    """(units a tile, chains a tile, shared-memory bytes) of a launch of
    the tiled kernel ``kind`` (one of TILE_KINDS) at n observations a unit
    (for "seg", a group's share of a chunk: its launcher takes SEG_OBS)
    and p covariates, as the kernel's launcher computes it: the largest
    power-of-two unit depth up to TILE_G_MAX whose tile still lets the
    kernel's TILE_BLOCKS blocks share an SM, else one unit up to SMEM_MAX.
    Raises where no tile fits."""
    if kind not in TILE_KINDS:
        raise ValueError(f"unknown tiled kernel {kind!r}")
    budget = SMEM_SM // TILE_BLOCKS[kind] - SMEM_RESERVED
    tg = TILE_G_MAX
    while tg >= 1:
        b = tile_bytes(kind, n, p, tg)
        if b <= budget:
            return tg, TILE_C, b
        tg //= 2
    b = tile_bytes(kind, n, p, 1)
    if b > SMEM_MAX:
        raise ValueError(
            f"{kind}: n={n} observations per unit at p={p} need {b} bytes "
            f"of shared memory for one unit, over the {SMEM_MAX} a block "
            "may take"
        )
    return 1, TILE_C, b


def fold_scalars(rhat_fold, device):
    """The (2, 2) fold scalars [[cnt, act], [cnt, act]] as the contiguous
    float32 tensor on ``device`` the kernel reads (a captured draw's row of
    the segment's table as it is; host scalars copied), None without a
    fold."""
    if rhat_fold is None:
        return None
    return torch.as_tensor(rhat_fold[2], dtype=torch.float32).to(
        device).reshape(2, 2).contiguous()
