"""The MH-within-Gibbs sweep — the hot loop body.

Port of :mod:`nestmc.kernels.gibbs` for the Newton-MH path. One sweep
updates every block in declaration order: exact conditional (Gibbs) draws,
then each Newton-MH block through the model's fused Newton step
(ops/cuda/newton_accept), then the joint moves. The device of the tensors
picks the step's form: CUDA tensors launch the CUDA kernel, CPU tensors run
its plain version. KernelConfig.fused_accept and fused_accept_warmup do not
change the path. Newton-MH is never scale-adapted, and the Newton-mode
interweaving move is parameter-free, so warmup adapts nothing here:
``adapt`` only selects the refresh (warmup) or frozen (sampling) metric.
"""

from __future__ import annotations

import inspect

from nestmc_torch.config import SamplerConfig, validate
from nestmc_torch.kernels.state import KernelState
from nestmc_torch.model import ModelSpec


def _takes(fn, kwarg: str) -> bool:
    return kwarg in inspect.signature(fn).parameters


def joint_move_target(model: ModelSpec, mname: str) -> "float | None":
    """Acceptance target of a joint move's scale adaptation. With a live
    Newton cache an 'auto' move is a parameter-free Laplace proposal:
    None, nothing to adapt."""
    t = model.joint_move_target_accept.get(mname, 0.234)
    if t is None or t == "auto":
        return None
    return float(t)


def rhat_fold_names(model: ModelSpec, cfg: SamplerConfig) -> tuple:
    """Blocks whose streaming-R-hat Welford update the sweep folds in its
    Newton step: the non-Gibbs blocks whose fused hook takes ``rhat_fold``."""
    return tuple(
        b.name for b in model.blocks
        if b.name not in model.gibbs_draws
        and b.name in model.fused_updates_newton
        and _takes(model.fused_updates_newton[b.name], "rhat_fold")
    )


def make_sweep(model: ModelSpec, cfg: SamplerConfig):
    """Build sweep(state, data, adapt, rng, rhat_fold=None) -> state.

    rhat_fold: optional {block: (mean, m2, scalars)} kernel-layout
    accumulators folded with each block's PRE-update value (the previous
    retained draw); the return is then (state, {block: (mean', m2')}).
    """
    validate(cfg)
    for b in model.blocks:
        if (b.name not in model.gibbs_draws
                and b.name not in model.fused_updates_newton):
            raise NotImplementedError(
                f"block {b.name!r} has no fused Newton step; the unfused "
                "update (kernels/newton.py) has no CUDA kernel"
            )
    for mname in model.joint_moves:
        if joint_move_target(model, mname) is not None:
            raise NotImplementedError(
                f"joint move {mname!r} needs scale adaptation (adapt.py), "
                "which is not ported"
            )
    move_takes_frozen = {
        m: _takes(fn, "frozen") for m, fn in model.joint_moves.items()
    }

    def sweep(state: KernelState, data, adapt: bool, rng, rhat_fold=None):
        frozen = (not adapt) and cfg.kernel.newton_freeze
        position = dict(state.position)
        accept_sum = dict(state.accept_sum)
        cache = dict(state.cache)
        fold_out = {}
        folds = rhat_fold or {}

        for block in model.blocks:
            name = block.name
            if name in model.gibbs_draws:
                position[name] = model.gibbs_draws[name](rng, position, data)
                accept_sum[name] = accept_sum[name] + 1.0
                continue
            hook = model.fused_updates_newton[name]
            fold_args = folds.get(name)
            alphas = []
            for r in range(max(1, block.repeats)):
                if fold_args is not None and r == 0:
                    out = hook(
                        rng, position, cache, state.log_scale[name],
                        data, frozen=frozen, rhat_fold=fold_args,
                    )
                    fold_out[name] = out[3]
                else:
                    out = hook(
                        rng, position, cache, state.log_scale[name],
                        data, frozen=frozen,
                    )
                new_value, new_cache, alpha = out[:3]
                position[name] = new_value
                cache[name] = new_cache
                alphas.append(alpha)
            accept_sum[name] = accept_sum[name] + sum(alphas) / len(alphas)

        for mname, move in model.joint_moves.items():
            alphas = []
            for _ in range(max(1, model.joint_move_repeats.get(mname, 1))):
                pos_up, cache_up, alpha = move(
                    rng, position, cache, state.log_scale[mname].exp(),
                    data,
                    **({"frozen": frozen} if move_takes_frozen[mname]
                       else {}),
                )
                position.update(pos_up)
                cache.update(cache_up)
                alphas.append(alpha[:, None])
            accept_sum[mname] = accept_sum[mname] + sum(alphas) / len(alphas)

        new_state = KernelState(
            position=position,
            log_scale=state.log_scale,
            accept_sum=accept_sum,
            cache=cache,
            t=state.t + 1,
        )
        if rhat_fold is None:
            return new_state
        return new_state, fold_out

    return sweep
