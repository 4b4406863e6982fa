"""The explicit random-number source of one run.

The reference threads a JAX key through every draw. The port passes one
:class:`SweepRNG` instead: a ``torch.Generator`` on the data's device for
tensors, and a CPU generator for the two 32-bit Philox key words each
kernel launch takes by value (drawing them needs no device sync). There is
no global RNG anywhere in the port. Tests replace it with an object of the
same methods that replays the reference's noise.
"""

from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float32).tiny


class SweepRNG:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.host = torch.Generator()
        self.host.manual_seed(seed + 0x5EED)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(
            tuple(shape), generator=self.generator, device=self.device
        )

    def log_uniform(self, shape) -> torch.Tensor:
        """log u, u uniform on [tiny, 1) as the reference draws it."""
        u = torch.rand(
            tuple(shape), generator=self.generator, device=self.device
        )
        return torch.log(u.clamp_min(_TINY))

    def gamma(self, a: float, shape) -> torch.Tensor:
        """Gamma(a, 1) draws."""
        conc = torch.full(tuple(shape), float(a), device=self.device)
        return torch._standard_gamma(conc, generator=self.generator)

    def poisson(self, rate: torch.Tensor) -> torch.Tensor:
        """Poisson(rate) counts as float32, elementwise (sample_data)."""
        return torch.poisson(rate, generator=self.generator)

    def philox_key(self) -> tuple:
        """Two 32-bit words keying one kernel launch's Philox streams."""
        w = torch.randint(
            0, 2**32, (2,), generator=self.host, dtype=torch.int64
        )
        return int(w[0]), int(w[1])


class ReplayRNG:
    """Hands out given arrays, in order, in place of fresh draws: feeds the
    port the exact noise another sampler drew (the parity tests). Each
    request must match the next array's shape; ``gamma`` ignores ``a``."""

    def __init__(self, arrays, device="cpu"):
        self.device = torch.device(device)
        self._queue = list(arrays)

    def _next(self, shape) -> torch.Tensor:
        if not self._queue:
            raise IndexError("ReplayRNG: no draws left")
        a = torch.as_tensor(self._queue.pop(0), dtype=torch.float32)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"ReplayRNG: next draw has shape {tuple(a.shape)}, "
                f"requested {tuple(shape)}"
            )
        return a.to(self.device)

    def normal(self, shape):
        return self._next(shape)

    def log_uniform(self, shape):
        return self._next(shape)

    def gamma(self, a: float, shape):
        return self._next(shape)

    def philox_key(self):
        raise RuntimeError("ReplayRNG replays given noise: pass it as noise")

    @property
    def remaining(self) -> int:
        return len(self._queue)
