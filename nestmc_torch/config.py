"""Frozen dataclass configs — the knobs of the sampler.

Same field names and defaults as :mod:`nestmc.config`, copied rather than
imported because importing ``nestmc`` imports JAX. The deprecated
``KernelConfig.fused_sweep`` is gone. :func:`validate` raises on values
out of range.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class KernelConfig:
    """MH kernel knobs.

    algorithm: 'rwmh' (random-walk, kernels/rwmh.py), 'mala' (Langevin,
      kernels/mala.py) or 'newton' (Laplace-proposal MH, kernels/newton.py);
      per-block override via Block.algorithm.
    newton_freeze: freeze the carried likelihood Hessian at warmup end; the
      sampling-phase obs pass then computes only (value, grad).
    target_accept: None picks the per-block optimum (0.44 scalar RW / 0.234
      multivariate RW / 0.574 MALA).
    adapt_*: Robbins-Monro schedule log s += c (t + 1 + t0)^-kappa
      (alpha - target), warmup only (adapt.py).
    fused_accept and fused_accept_warmup keep the reference's names but are
    carried unused: a block with a fused step and no preconditioner always
    runs it (the CUDA kernel on CUDA tensors, its plain version on CPU
    tensors).
    precond: 'none', 'diag' (per-coordinate EMA variance) or 'full'
      (per-unit Haario EMA covariance; 'diag' for scalar units), learned
      in warmup with decay precond_decay and ridge precond_reg (adapt.py);
      a block with a preconditioner takes the plain update of its
      algorithm, as the reference's sweep does.
    """

    algorithm: str = "rwmh"
    fused_accept: bool = False
    fused_accept_warmup: bool = True
    newton_freeze: bool = True
    target_accept: float | None = None
    adapt_c: float = 1.0
    adapt_t0: float = 10.0
    adapt_kappa: float = 0.6
    precond: str = "none"
    precond_decay: float = 0.02
    precond_reg: float = 1e-6
    scale_per_unit: bool = True


@dataclass(frozen=True)
class RunConfig:
    """Chain/draw schedule.

    chains: total chains.
    warmup: adapting sweeps (discarded).
    draws: retained draws per chain.
    thin: sweeps per retained draw.
    seed: seeds the run's torch.Generators.
    segment_size: sweeps (warmup) or draws (sampling) between log lines
      and checkpoints.
    collect: {block_name: None | k | (i, j, ...)} as in the reference.
    full_rhat: stream classic split R-hat (and the cross-chain ESS) over
      every unit of every block.
    full_rhat_thin: fold every k-th retained draw into the streamed R-hat
      and ESS accumulators (k >= 1; the in-kernel fold runs only at k = 1).
    checkpoint_dir, checkpoint_every: save the carry (checkpoint.py) after
      every checkpoint_every-th segment of either phase (0 = never).
    log_rhat: log the worst split R-hat of the draws so far once a
      sampling segment (with log_every_segment).
    """

    chains: int = 64
    warmup: int = 500
    draws: int = 1000
    thin: int = 1
    seed: int = 0
    segment_size: int = 500
    collect: dict | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    log_every_segment: bool = True
    full_rhat: bool = False
    full_rhat_thin: int = 1
    log_rhat: bool = False


@dataclass(frozen=True)
class ShardingConfig:
    """Device layout: chain_shards x group_shards ranks, one process (and
    device) a rank (nestmc_torch/parallel). donate_carry is carried for
    the reference's surface: its counterpart, the static carry that each
    step reads and writes in place (nestmc_torch/segments.py), is always
    used."""

    chain_shards: int = 1
    group_shards: int = 1
    donate_carry: bool = True


@dataclass(frozen=True)
class SamplerConfig:
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SamplerConfig":
        return SamplerConfig(
            kernel=KernelConfig(**d.get("kernel", {})),
            run=RunConfig(**d.get("run", {})),
            sharding=ShardingConfig(**d.get("sharding", {})),
        )


def rw_target_accept(unit_dim: int) -> float:
    """Roberts-Gelman-Gilks optimal RW-MH acceptance by dimension."""
    return 0.44 if unit_dim == 1 else 0.234


MALA_TARGET_ACCEPT = 0.574
ALGORITHMS = ("rwmh", "mala", "newton")


PRECONDS = ("none", "diag", "full")


def validate(cfg: SamplerConfig) -> None:
    """Raise on every setting the port does not run."""
    k, r, s = cfg.kernel, cfg.run, cfg.sharding
    if k.algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm={k.algorithm!r}: one of {ALGORITHMS}")
    if k.precond not in PRECONDS:
        raise ValueError(f"precond={k.precond!r}: one of {PRECONDS}")
    if r.thin < 1:
        raise ValueError(f"thin={r.thin}: must be >= 1")
    if r.full_rhat_thin < 1:
        raise ValueError(f"full_rhat_thin={r.full_rhat_thin}: must be >= 1")
    if s.chain_shards < 1 or s.group_shards < 1:
        raise ValueError(f"chain_shards={s.chain_shards}, group_shards="
                         f"{s.group_shards}: each must be >= 1")
    if r.chains < s.chain_shards:
        raise ValueError(f"chains={r.chains} < chain_shards="
                         f"{s.chain_shards}")
    if r.checkpoint_every < 0:
        raise ValueError(f"checkpoint_every={r.checkpoint_every}: >= 0")
