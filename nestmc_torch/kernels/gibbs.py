"""The MH-within-Gibbs sweep — the hot loop body.

Port of :mod:`nestmc.kernels.gibbs`. One sweep updates every block in
declaration order (exact conditional draws for Gibbs blocks, an MH update
for the others), then runs the joint moves. A block whose algorithm has a
fused step in the model (fused_updates / fused_updates_mala /
fused_updates_newton) and no preconditioner always runs it: the CUDA kernel
on CUDA tensors, its plain version on CPU tensors, whatever
KernelConfig.fused_accept and fused_accept_warmup say. Other blocks run
the unfused update of their algorithm (kernels/rwmh.py, mala.py,
newton.py); so does a block with a preconditioner (KernelConfig.precond),
as the reference's sweep does (the fused steps take none). In warmup
(``adapt``) the RW-MH and MALA scales of blocks and joint moves adapt by
Robbins-Monro (adapt.py) to their targets, and the blocks' preconditioner
moments by their EMA; Newton-MH and a parameter-free (Laplace) move
are never adapted, and ``adapt`` also selects the Newton metric's refresh
(warmup) or frozen (sampling) form.

Each sweep runs in a ``sweep`` span (utils/profiling.span), each block in
``block.<name>`` (with the plain R-hat fold of a block whose fused step
does not fold it) and each joint move in ``move.<name>``: device-timed
spans when the caller records them (``sample(..., spans=True)``).
"""

from __future__ import annotations

import inspect

from nestmc_torch.adapt import adapt_log_scale, precond_std, update_precond
from nestmc_torch.config import (
    MALA_TARGET_ACCEPT,
    SamplerConfig,
    rw_target_accept,
    validate,
)
from nestmc_torch.diagnostics import fold_rhat_update
from nestmc_torch.kernels.mala import mala_update
from nestmc_torch.kernels.newton import newton_update
from nestmc_torch.kernels.rwmh import rwmh_update
from nestmc_torch.kernels.state import KernelState
from nestmc_torch.model import ModelSpec
from nestmc_torch.parallel.collectives import groups_sum, unit_span
from nestmc_torch.utils.profiling import SWEEP, span

_UPDATES = {"rwmh": rwmh_update, "mala": mala_update, "newton": newton_update}


def _takes(fn, kwarg: str) -> bool:
    return kwarg in inspect.signature(fn).parameters


def block_algorithm(block, model: ModelSpec, cfg: SamplerConfig) -> str:
    """The block's algorithm; Newton falls back to MALA for a block
    without the model's analytic Hessian (e.g. a half-normal log_tau MH
    block in an otherwise-Newton model)."""
    algorithm = block.algorithm or cfg.kernel.algorithm
    if algorithm == "newton" and block.name not in model.cond_cached_newton:
        algorithm = "mala"
    return algorithm


def fused_table(model: ModelSpec, algorithm: str) -> dict:
    return {
        "rwmh": model.fused_updates,
        "mala": model.fused_updates_mala,
        "newton": model.fused_updates_newton,
    }[algorithm]


def _mh_blocks(model: ModelSpec):
    return [b for b in model.blocks if b.name not in model.gibbs_draws]


def grad_cache_live(model: ModelSpec, cfg: SamplerConfig) -> bool:
    """True when some MALA or Newton block carries a gradient cache, so the
    carried cache holds {'v', 'g', ...} and gradient-aware joint moves
    (Langevin interweaving) engage."""
    return any(
        (block_algorithm(b, model, cfg) == "mala"
         and b.name in model.cond_cached_grad)
        or block_algorithm(b, model, cfg) == "newton"
        for b in _mh_blocks(model)
    )


def newton_cache_live(model: ModelSpec, cfg: SamplerConfig) -> bool:
    """True when some block runs Newton-MH, so the cache also carries the
    packed likelihood Hessian and joint moves can be Laplace proposals."""
    return any(
        block_algorithm(b, model, cfg) == "newton" for b in _mh_blocks(model)
    )


def joint_move_target(model: ModelSpec, mname: str,
                      cfg: SamplerConfig) -> "float | None":
    """Acceptance target of a joint move's scale adaptation; None = the
    move is parameter-free (Laplace) and must not adapt. 'auto' resolves
    to None with a Newton cache, 0.574 with a gradient cache, else 0.234."""
    t = model.joint_move_target_accept.get(mname, 0.234)
    if t is None:
        return None
    if t == "auto":
        if newton_cache_live(model, cfg):
            return None
        t = MALA_TARGET_ACCEPT if grad_cache_live(model, cfg) else 0.234
    return float(t)


def block_target_accept(block, algorithm: str, cfg: SamplerConfig) -> float:
    if block.target_accept is not None:
        return block.target_accept
    if cfg.kernel.target_accept is not None:
        return cfg.kernel.target_accept
    if algorithm == "mala":
        return MALA_TARGET_ACCEPT
    return rw_target_accept(block.unit_dim)


def rhat_fold_names(model: ModelSpec, cfg: SamplerConfig) -> tuple:
    """Blocks whose streaming-R-hat Welford update the sweep folds into
    their fused step: the non-Gibbs blocks whose fused hook takes
    ``rhat_fold``. Only at full_rhat_thin == 1: a thinned run updates its
    accumulators after the sweep, on the selected draws only (engine.py),
    as the reference does."""
    if cfg.run.full_rhat_thin > 1:
        return ()
    out = []
    for b in _mh_blocks(model):
        hook = fused_table(model, block_algorithm(b, model, cfg)).get(b.name)
        if hook is not None and _takes(hook, "rhat_fold"):
            out.append(b.name)
    return tuple(out)


def make_sweep(model: ModelSpec, cfg: SamplerConfig):
    """Build sweep(state, data, adapt, rng, rhat_fold=None, gain=None) ->
    state.

    rhat_fold: optional {block: (mean, m2, scalars)} kernel-layout
    accumulators folded with each block's PRE-update value (the previous
    retained draw): in the fused step when its hook takes them, else by
    the plain fold; the return is then (state, {block: (mean', m2')}).
    Noise is drawn from ``rng`` in the reference's order: each block in
    turn (each repeat in turn), then each joint move. gain: the
    Robbins-Monro gain of this sweep as a float32 tensor (a captured
    sweep's entry of the segment's table), else rm_step_size(state.t).
    """
    validate(cfg)
    plan = {}
    for b in _mh_blocks(model):
        algorithm = block_algorithm(b, model, cfg)
        hook = fused_table(model, algorithm).get(b.name)
        plan[b.name] = (
            algorithm, hook,
            hook is not None and _takes(hook, "rhat_fold"),
            block_target_accept(b, algorithm, cfg),
        )
    move_takes_frozen = {
        m: _takes(fn, "frozen") for m, fn in model.joint_moves.items()
    }
    move_target = {
        m: joint_move_target(model, m, cfg) for m in model.joint_moves
    }

    def sweep(state: KernelState, data, adapt: bool, rng, rhat_fold=None,
              gain=None):
        frozen = (not adapt) and cfg.kernel.newton_freeze
        t = state.t
        position = dict(state.position)
        log_scale = dict(state.log_scale)
        accept_sum = dict(state.accept_sum)
        cache = dict(state.cache)
        precond = dict(state.precond)
        fold_out = {}
        folds = rhat_fold or {}

        with span(SWEEP):
            for block in model.blocks:
                name = block.name
                with span("block." + name):
                    if name in model.gibbs_draws:
                        position[name] = model.gibbs_draws[name](
                            rng, position, data)
                        accept_sum[name] = accept_sum[name] + 1.0
                        continue
                    algorithm, hook, hook_folds, target = plan[name]
                    pstd = precond_std(precond.get(name), cfg.kernel)
                    if pstd is not None:
                        hook, hook_folds = None, False
                    kw = {"frozen": frozen} if algorithm == "newton" else {}
                    # Newton-MH's metric is the conditional's own Hessian:
                    # no pstd
                    plain_kw = kw if algorithm == "newton" else {"pstd": pstd}
                    fold_args = folds.get(name)
                    if fold_args is not None and not hook_folds:
                        fold_out[name] = fold_rhat_update(
                            fold_args[0], fold_args[1],
                            position[name].movedim(0, -1), fold_args[2],
                        )
                        fold_args = None
                    alphas = []
                    for r in range(max(1, block.repeats)):
                        if hook is None:
                            new_value, alpha, new_cache = _UPDATES[
                                algorithm](
                                rng, block, model, position, log_scale[name],
                                data, cache=cache.get(name), **plain_kw,
                            )
                        elif fold_args is not None and r == 0:
                            out = hook(rng, position, cache, log_scale[name],
                                       data, rhat_fold=fold_args, **kw)
                            new_value, new_cache, alpha = out[:3]
                            fold_out[name] = out[3]
                        else:
                            new_value, new_cache, alpha = hook(
                                rng, position, cache, log_scale[name], data,
                                **kw
                            )
                        position[name] = new_value
                        cache[name] = new_cache
                        alphas.append(alpha)
                    alpha = sum(alphas) / len(alphas)
                    accept_sum[name] = accept_sum[name] + alpha
                    if adapt and algorithm != "newton":
                        # scales shared across units see the mean over
                        # units (of every group shard when the block's units
                        # are split)
                        if alpha.shape[1] != log_scale[name].shape[1]:
                            axis = model.unit_axes.get(name)
                            if (axis is not None
                                    and unit_span(axis) is not None):
                                alpha = groups_sum(alpha, 1, keepdim=True) / (
                                    block.units)
                            else:
                                alpha = alpha.mean(dim=1, keepdim=True)
                        log_scale[name] = adapt_log_scale(
                            log_scale[name], alpha, t, target, cfg.kernel,
                            gain
                        )
                        precond[name] = update_precond(
                            precond.get(name), new_value, cfg.kernel)

            for mname, move in model.joint_moves.items():
                with span("move." + mname):
                    alphas = []
                    repeats = model.joint_move_repeats.get(mname, 1)
                    for _ in range(max(1, repeats)):
                        pos_up, cache_up, alpha = move(
                            rng, position, cache, log_scale[mname].exp(), data,
                            **({"frozen": frozen} if move_takes_frozen[mname]
                               else {}),
                        )
                        position.update(pos_up)
                        cache.update(cache_up)
                        alphas.append(alpha[:, None])
                    alpha = sum(alphas) / len(alphas)
                    accept_sum[mname] = accept_sum[mname] + alpha
                    if adapt and move_target[mname] is not None:
                        log_scale[mname] = adapt_log_scale(
                            log_scale[mname], alpha, t, move_target[mname],
                            cfg.kernel, gain,
                        )

        new_state = KernelState(
            position=position,
            log_scale=log_scale,
            accept_sum=accept_sum,
            cache=cache,
            t=t + 1,
            precond=precond,
        )
        if rhat_fold is None:
            return new_state
        return new_state, fold_out

    return sweep
