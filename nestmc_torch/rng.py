"""The explicit random-number source of one run.

The reference threads a JAX key through every draw. The port passes one
:class:`SweepRNG` instead: a ``torch.Generator`` on the data's device for
tensors, and a CPU generator for the two 32-bit Philox key words of each
kernel launch (drawing them needs no device sync). A kernel reads its
words from device memory (:meth:`SweepRNG.key_words`): either copied there
at the launch, or, in a captured segment (nestmc_torch/segments.py), the
sweep's row of a key table that holds every word the segment's launches
take, drawn from the CPU generator in launch order before the segment
(:meth:`SweepRNG.key_table`, the same words as that many philox_key()
calls). There is no global RNG anywhere in the port. A checkpoint carries
both generators' states (:meth:`SweepRNG.get_state`), so a resumed run
draws the same noise an uninterrupted one would. Tests replace it with an
object of the same methods that replays the reference's noise.

A draw whose tensor has a unit axis (dim 1 of (C, U, ...): a block's
proposal noise and accept uniforms, a per-unit conjugate draw) says so
with ``units=(1, u0, U)``: the tensor holds units u0.. of U (U None: all
of them). It is a counter-indexed fill (ops/cuda/philox_fill: the
hand-written kernel on the card, its plain version on the CPU): one pair
of Philox key words taken like a kernel launch's (:meth:`key_words`, so a
captured step reads it from the key table), and element g of the
unsharded tensor keyed by g. A sharded run (nestmc_torch.parallel) keeps
the unsharded run's draws: every rank seeds the same generators, and a
rank that holds chains c0.. of C (:attr:`SweepRNG.chains`) and units
u0.. fills only its own (chain span x unit span) block. A draw without a
unit axis (a population block's (C, p)) and every gamma draw come from
the device generator, drawn at the global shape and sliced to the
rank's chains; such a draw is the same on every group shard of a chain
shard.
"""

from __future__ import annotations

import numpy as np
import torch

_TINY = torch.finfo(torch.float32).tiny


class SweepRNG:
    """chains: None, or (c0, C) when this process holds chains c0.. of C
    (a chain shard): every draw's leading axis is then the chains axis."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.host = torch.Generator()
        self.host.manual_seed(seed + 0x5EED)
        self.chains = None
        self._keys = None   # the sweep's (K, 2) key words (use_keys)
        self._slot = 0

    def _sharded(self, draw, shape, units):
        """draw(shape) when this process holds the whole of it, else the
        slice of draw(global shape) it holds."""
        shape = tuple(shape)
        if self.chains is None and units is None:
            return draw(shape)
        full, idx = list(shape), [slice(None)] * len(shape)
        if self.chains is not None:
            c0, full[0] = self.chains
            idx[0] = slice(c0, c0 + shape[0])
        if units is not None:
            axis, u0, full[axis] = units
            idx[axis] = slice(u0, u0 + shape[axis])
        return draw(tuple(full))[tuple(idx)].contiguous()

    def _fill(self, mode, shape, units):
        """The counter-indexed fill of this process's block of a draw
        with a unit axis (see the module)."""
        from nestmc_torch.ops.cuda.philox_fill import philox_fill

        dim, u0, total = units
        if dim != 1:
            raise ValueError(f"a unit-axis draw has its units at dim 1, "
                             f"not {dim}")
        shape = tuple(shape)
        c0 = 0 if self.chains is None else int(self.chains[0])
        U = shape[1] if total is None else int(total)
        return philox_fill(shape, self.key_words(self.device), c0, int(u0),
                           U, mode, self.device)

    def normal(self, shape, units=None) -> torch.Tensor:
        """Standard normals; ``units`` (1, u0, U) for a draw with a unit
        axis (the fill), None for one without."""
        if units is not None:
            return self._fill("normal", shape, units)
        return self._sharded(lambda s: torch.randn(
            s, generator=self.generator, device=self.device), shape, None)

    def log_uniform(self, shape, units=None) -> torch.Tensor:
        """log u, u uniform on (0, 1) as the reference draws it (24-bit
        uniforms offset off zero in the fill; else on [tiny, 1))."""
        if units is not None:
            return self._fill("log_uniform", shape, units)
        u = self._sharded(lambda s: torch.rand(
            s, generator=self.generator, device=self.device), shape, None)
        return torch.log(u.clamp_min(_TINY))

    def gamma(self, a, shape, units=None) -> torch.Tensor:
        """Gamma(a, 1) draws; ``a`` a float or a tensor broadcast to
        ``shape`` (a per-element or per-chain concentration; not in a
        sharded run, where it would have to be the global one)."""
        if torch.is_tensor(a):
            if self.chains is not None or units is not None:
                raise NotImplementedError(
                    "gamma with a tensor concentration in a sharded run")
            conc = a.to(device=self.device, dtype=torch.float32).expand(
                tuple(shape)).contiguous()
            return torch._standard_gamma(conc, generator=self.generator)
        return self._sharded(lambda s: torch._standard_gamma(
            torch.full(s, float(a), device=self.device),
            generator=self.generator), shape, units)

    def poisson(self, rate: torch.Tensor) -> torch.Tensor:
        """Poisson(rate) counts as float32, elementwise (sample_data)."""
        return torch.poisson(rate, generator=self.generator)

    def binomial(self, count: torch.Tensor, prob: torch.Tensor):
        """Binomial(count, prob) successes as float32, elementwise."""
        return torch.binomial(count, prob, generator=self.generator)

    def philox_key(self) -> tuple:
        """Two 32-bit words keying one kernel launch's Philox streams."""
        w = torch.randint(
            0, 2**32, (2,), generator=self.host, dtype=torch.int64
        )
        return int(w[0]), int(w[1])

    def key_table(self, launches: int) -> torch.Tensor:
        """(launches, 2) int32 (the uint32 words' bits): the words of the
        next ``launches`` philox_key() calls, in order, drawn at once; the
        CPU generator is left where those calls would leave it (one
        randint of 2 x launches words draws them in the same order)."""
        w = torch.randint(0, 2**32, (launches, 2), generator=self.host,
                          dtype=torch.int64)
        return words_i32(w)

    def use_keys(self, row) -> None:
        """Hand the next launches the (K, 2) device words of ``row`` in
        turn (a captured sweep's row of the segment's key table); None:
        each launch draws its words when it asks."""
        self._keys = row
        self._slot = 0

    @property
    def keys_taken(self) -> int:
        """Launches that took a word pair of the row since use_keys."""
        return self._slot

    def skip_key(self) -> None:
        """Take the next launch's key words and use none of them (a launch
        a group shard skips): the row's next pair, else philox_key()'s."""
        if self._keys is None:
            self.philox_key()
        else:
            self.key_words(self._keys.device)

    def key_words(self, device) -> torch.Tensor:
        """The next kernel launch's two Philox key words, a (2,) int32
        tensor on ``device`` that the kernel reads: the next pair of the
        row set by :meth:`use_keys`, else philox_key()'s words copied to
        the device (from pinned memory, without a sync)."""
        if self._keys is not None:
            if self._slot >= self._keys.shape[0]:
                raise RuntimeError(
                    f"the sweep's key row holds {self._keys.shape[0]} "
                    "launches' words; a launch asked for one more")
            words = self._keys[self._slot]
            self._slot += 1
            return words
        words = words_i32(torch.tensor(self.philox_key(),
                                       dtype=torch.int64))
        if torch.device(device).type != "cuda":
            return words
        return words.pin_memory().to(device, non_blocking=True)

    def get_state(self) -> dict:
        """{'device': the tensor generator's state, 'host': the key-word
        generator's}, uint8 CPU tensors (torch.Generator.get_state)."""
        return {"device": self.generator.get_state(),
                "host": self.host.get_state()}

    def set_state(self, state: dict) -> None:
        """Restore both generators from :meth:`get_state`'s dict."""
        self.generator.set_state(state["device"].cpu())
        self.host.set_state(state["host"].cpu())


def words_i32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 as int32 tensors of the same bits."""
    return torch.from_numpy(
        words.numpy().astype(np.uint32).view(np.int32).copy())


class ReplayRNG:
    """Hands out given arrays, in order, in place of fresh draws: feeds the
    port the exact noise another sampler drew (the parity tests). Each
    request must match the next array's shape; ``gamma``, ``poisson`` and
    ``binomial`` ignore their parameters but for the shape."""

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

    def normal(self, shape, units=None):
        return self._next(shape)

    def log_uniform(self, shape, units=None):
        return self._next(shape)

    def gamma(self, a, shape, units=None):
        return self._next(shape)

    def poisson(self, rate):
        return self._next(rate.shape)

    def binomial(self, count, prob):
        return self._next(torch.broadcast_shapes(count.shape, prob.shape))

    def philox_key(self):
        raise RuntimeError("ReplayRNG replays given noise: pass it as noise")

    @property
    def remaining(self) -> int:
        return len(self._queue)
