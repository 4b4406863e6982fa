"""Frozen dataclass configs — the knobs of the sampler.

Same field names and defaults as :mod:`nestmc.config`, copied rather than
imported because importing ``nestmc`` imports JAX. The deprecated
``KernelConfig.fused_sweep`` is gone. The port runs one path: Newton-MH
group updates on one device with no preconditioner and no thinning;
:func:`validate` raises on any other setting.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class KernelConfig:
    """MH kernel knobs.

    algorithm: only 'newton' (Laplace-proposal MH, kernels/newton.py) runs
      in the port so far.
    newton_freeze: freeze the carried likelihood Hessian at warmup end; the
      sampling-phase obs pass then computes only (value, grad).
    fused_accept, fused_accept_warmup, adapt_* and precond_* keep the
    reference's names but are carried unused: the port always runs the
    fused Newton step (the CUDA kernel on CUDA tensors, its plain version
    on CPU tensors), and Newton-MH is never scale-adapted.
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
    thin: sweeps per retained draw (only 1).
    seed: seeds the run's torch.Generators.
    segment_size: draws between log lines.
    collect: {block_name: None | k | (i, j, ...)} as in the reference.
    full_rhat: stream classic split R-hat (and the cross-chain ESS) over
      every unit of every block.
    full_rhat_thin: only 1.
    checkpoint_dir, checkpoint_every, log_rhat: kept for config
      compatibility; the port has no checkpoints and raises if they are set.
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
    """Device layout. The port runs on one device: only (1, 1)."""

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


def validate(cfg: SamplerConfig) -> None:
    """Raise NotImplementedError on every setting the port does not run."""
    k, r, s = cfg.kernel, cfg.run, cfg.sharding
    if k.algorithm != "newton":
        raise NotImplementedError(
            f"algorithm={k.algorithm!r}: only 'newton' is ported "
            "(ROADMAP Queue 1: MALA/RW variants)"
        )
    if k.precond != "none":
        raise NotImplementedError(f"precond={k.precond!r}: not ported")
    if r.thin != 1 or r.full_rhat_thin != 1:
        raise NotImplementedError("thin/full_rhat_thin != 1: not ported")
    if (s.chain_shards, s.group_shards) != (1, 1):
        raise NotImplementedError(
            "sharding: the port runs on one device (ROADMAP Queue 1)"
        )
    if r.checkpoint_dir or r.checkpoint_every:
        raise NotImplementedError("checkpoints: not ported (ROADMAP Queue 1)")
    if r.log_rhat:
        raise NotImplementedError("log_rhat: not ported")
