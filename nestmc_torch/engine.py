"""Chain orchestration: warmup, then sampling, as Python loops over sweeps.

Port of :mod:`nestmc.engine` for one device. PyTorch runs eagerly, so each
phase is a loop over sweeps on the data's device; the two phases stay
separate and the metric freezes at warmup end (KernelConfig.newton_freeze).
Retained draws (RunConfig.collect: blocks, and the model's derived
quantities computed from the position) go into buffers of shape
(C, D, ...) allocated before the sampling loop. With RunConfig.full_rhat every block streams split-R-hat
Welford accumulators; blocks whose fused step folds them in-kernel
(kernels/gibbs.rhat_fold_names) fold each draw one sweep late, with the
pre-update value, and the last draw is flushed after the loop. With
RunConfig.full_rhat_thin = k > 1 nothing folds in-kernel: every block's
accumulators are updated after the sweep, on retained draws j with
j % k == 0 only (as thinned draw j // k).
Timings synchronise the device before every clock read.

Not ported: checkpoints, sharding, resume (init_state, init_acc,
draws_offset), and
the reference's remote-backend warm-up and compile retries.
"""

from __future__ import annotations

import logging
import time

import torch

from nestmc_torch.config import SamplerConfig, validate
from nestmc_torch.data import data_device
from nestmc_torch.diagnostics import (
    fold_ess_finalize,
    fold_rhat_finalize,
    fold_rhat_init,
    fold_rhat_scalars,
    fold_rhat_update,
    streaming_ess_finalize,
    streaming_rhat_finalize,
    streaming_rhat_init,
    streaming_rhat_update,
)
from nestmc_torch.kernels.gibbs import make_sweep, rhat_fold_names
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.model import ModelSpec
from nestmc_torch.posterior import Posterior
from nestmc_torch.rng import SweepRNG

log = logging.getLogger("nestmc_torch")


def _collect(position, spec, derived):
    """{name: (C, *shape)} of what RunConfig.collect retains: block names
    and the model's derived quantities (computed from the position), all
    of both when ``spec`` is None."""
    if spec is None:
        return {**position, **{k: fn(position) for k, fn in derived.items()}}
    out = {}
    for name, k in spec.items():
        v = derived[name](position) if name in derived else position[name]
        if k is None:
            out[name] = v
        elif isinstance(k, int):
            out[name] = v[:, :k]
        else:
            idx = torch.as_tensor(k, dtype=torch.long, device=v.device)
            out[name] = v.index_select(1, idx)
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _segments(total: int, segment: int):
    segment = max(1, min(segment, total)) if total else 0
    done = 0
    while done < total:
        n = min(segment, total - done)
        yield done, n
        done += n


def sample(
    model: ModelSpec,
    data,
    cfg: SamplerConfig | None = None,
    rng: SweepRNG | None = None,
) -> Posterior:
    """Run the sampler end to end on the data's device (data_device: its
    ``device``, else that of its first tensor); returns a
    :class:`Posterior`. ``rng`` defaults to SweepRNG(cfg.run.seed)."""
    cfg = cfg or SamplerConfig()
    validate(cfg)
    rc = cfg.run
    device = data_device(data)
    if rng is None:
        rng = SweepRNG(rc.seed, device)

    _sync(device)
    t_setup = time.perf_counter()
    state = init_kernel_state(model, cfg, rng, data)
    sweep = make_sweep(model, cfg)
    _sync(device)
    timings = {"setup_s": time.perf_counter() - t_setup}

    # ---- warmup: refreshed metric ----
    warm_rates = {k: torch.zeros_like(v) for k, v in state.accept_sum.items()}
    t_w = time.perf_counter()
    if rc.warmup > 0:
        for start, n in _segments(rc.warmup, rc.segment_size):
            for _ in range(n):
                state = sweep(state, data, True, rng)
            if rc.log_every_segment:
                _sync(device)
                log.info("warmup: %d/%d sweeps (%.0f sweeps/s)",
                         start + n, rc.warmup,
                         (start + n) / max(time.perf_counter() - t_w, 1e-9))
        warm_rates = {k: v / rc.warmup for k, v in state.accept_sum.items()}
        state.accept_sum = {
            k: torch.zeros_like(v) for k, v in state.accept_sum.items()
        }
    _sync(device)
    timings["warmup_s"] = time.perf_counter() - t_w

    # ---- sampling: frozen metric ----
    D = rc.draws
    rthin = rc.full_rhat_thin
    half_len = (D // rthin) // 2
    fold_names = rhat_fold_names(model, cfg) if rc.full_rhat else ()
    std_acc, fold_acc = {}, {}
    if rc.full_rhat and D > 0:
        std_acc = streaming_rhat_init({
            k: v for k, v in state.position.items() if k not in fold_names
        })
        fold_acc = fold_rhat_init(state.position, fold_names)
    views = _collect(state.position, rc.collect, model.derived)
    draws = {
        k: torch.empty((v.shape[0], D) + tuple(v.shape[1:]), device=device)
        for k, v in views.items()
    }

    _sync(device)
    t_s = time.perf_counter()
    for start, n in _segments(D, rc.segment_size):
        for j in range(start, start + n):
            if fold_acc:
                # fold retained draw j-1 (nothing pending at j == 0)
                jm1 = j - 1 if j >= 1 else -1
                scs = {
                    k: fold_rhat_scalars(fold_acc[k][0], jm1, half_len)
                    for k in fold_names
                }
                folds = {
                    k: (fold_acc[k][1], fold_acc[k][2], scs[k])
                    for k in fold_names
                }
                state, fout = sweep(state, data, False, rng, folds)
                fold_acc = {
                    k: (fold_acc[k][0] + scs[k][:, 1], *fout[k])
                    for k in fold_names
                }
            else:
                state = sweep(state, data, False, rng)
            if std_acc and j % rthin == 0:
                std_acc = streaming_rhat_update(
                    std_acc, state.position, j // rthin, half_len
                )
            for k, v in _collect(state.position, rc.collect,
                                 model.derived).items():
                draws[k][:, j] = v
        if rc.log_every_segment:
            _sync(device)
            log.info("sample: %d/%d draws (%.0f sweeps/s)", start + n, D,
                     (start + n) / max(time.perf_counter() - t_s, 1e-9))
    _sync(device)
    timings["sample_s"] = time.perf_counter() - t_s

    full_rhat = full_ess = None
    if std_acc or fold_acc:
        if fold_acc:
            # the in-sweep fold lags one draw: flush the last retained
            # draw, if the thinning selects it
            last = D - 1
            last_t = last // rthin if last % rthin == 0 else -1
            for k in fold_names:
                count, mean, m2 = fold_acc[k]
                sc = fold_rhat_scalars(count, last_t, half_len)
                nm, nm2 = fold_rhat_update(
                    mean, m2, state.position[k].movedim(0, -1), sc
                )
                fold_acc[k] = (count + sc[:, 1], nm, nm2)
        full_rhat = {
            **streaming_rhat_finalize(std_acc),
            **fold_rhat_finalize(fold_acc),
        }
        full_ess = {
            **streaming_ess_finalize(std_acc),
            **fold_ess_finalize(fold_acc),
        }

    post = Posterior(
        draws=draws,
        accept_rates={k: v / max(D, 1) for k, v in state.accept_sum.items()},
        warmup_accept_rates=warm_rates,
        config=cfg.to_dict(),
        timings=timings,
        full_rhat=full_rhat,
        full_ess=full_ess,
    )
    post.final_state = state
    return post
