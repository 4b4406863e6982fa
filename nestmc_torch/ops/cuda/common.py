"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


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


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_smem(n: int, p: int) -> None:
    """The group's data must fit the 48 KB of default dynamic shared
    memory a block may use."""
    if 4 * n * (p + 2) > 48 * 1024:
        raise ValueError(
            f"n={n} observations per group at p={p} exceed the kernels' "
            "48 KB shared-memory stage"
        )


def fold_scalars(rhat_fold) -> list:
    """The (2, 2) fold scalars [[cnt, act], [cnt, act]] as host floats
    (identity [[1, 0], [1, 0]] without a fold), passed to a kernel by
    value."""
    if rhat_fold is None:
        return [[1.0, 0.0], [1.0, 0.0]]
    return torch.as_tensor(rhat_fold[2], dtype=torch.float32).tolist()
