"""Named presets of the port: (model, data, SamplerConfig) from a seed.

Port of the :mod:`nestmc.presets` entries the port runs, at full width (no
``scale``): the judged config of bench.py, config 5 (``mala-100k``), the
RW-MH state of config 2 (``hier-logistic-100-rw``) and config 3
(``nested-poisson-1k``, with its ``-mala`` and ``-newton`` variants). Data
come from the port's numpy ``synth_logistic`` / ``synth_poisson3`` with the
reference's seed offsets: the same generative models, other draws. The JAX
presets' sharding is dropped (one device) and their TPU measurements in
comments are not carried over. ``groups`` overrides G for small test runs
only.
"""

from __future__ import annotations

import dataclasses

from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.models import (
    make_hier_logistic,
    make_nested_poisson,
    synth_logistic,
    synth_poisson3,
)


def _judged(seed: int, device, groups):
    """bench.py's config: G=1000 groups x 50 obs, p=4, 1024 chains,
    1500/4096, frozen-metric Newton-MH with the fused step, invgamma tau,
    one interweaving move a sweep, streamed R-hat over every parameter."""
    data, _ = synth_logistic(seed + 2000, G=groups or 1000, n=50, p=4,
                             device=device)
    model = make_hier_logistic(data, tau_prior="invgamma", asis_repeats=1)
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton", fused_accept=True),
        run=RunConfig(
            chains=1024, warmup=1500, draws=4096, seed=seed,
            segment_size=2048,
            collect={"mu": None, "log_tau": None, "beta": 8},
            full_rhat=True, log_every_segment=False,
        ),
    )
    return model, data, cfg


def _mala_100k(seed: int, device, groups):
    """Config 5 (BASELINE.json configs[4]): 100k groups x 20 obs, p=3, 512
    chains, 1500/4096, MALA with the fused step, half-normal tau (MALA on
    log tau), the bound-metric Langevin interweaving move, streamed R-hat
    over every parameter on every 4th draw."""
    data, _ = synth_logistic(seed + 5000, G=groups or 100_000, n=20, p=3,
                             device=device)
    model = make_hier_logistic(data)
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="mala", fused_accept=True),
        run=RunConfig(
            chains=512, warmup=1500, draws=4096, seed=seed,
            collect={"mu": None, "log_tau": None, "beta": 8},
            full_rhat=True, full_rhat_thin=4,
        ),
    )
    return model, data, cfg


def _hier_logistic_100_rw(seed: int, device, groups):
    """Config 2's RW-MH state: 100 groups x 50 obs, p=4, 64 chains,
    1500/4096, adaptive RW-MH group updates, half-normal tau (RW-MH on log
    tau), the RW interweaving move."""
    data, _ = synth_logistic(seed + 1000, G=groups or 100, n=50, p=4,
                             device=device)
    model = make_hier_logistic(data)
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="rwmh"),
        run=RunConfig(
            chains=64, warmup=1500, draws=4096, seed=seed,
            segment_size=4096,
            collect={"mu": None, "log_tau": None, "beta": 16},
        ),
    )
    return model, data, cfg


def _nested_poisson_1k(seed: int, device, groups):
    """Config 3 (BASELINE.json's 3-level nested Poisson GLMM): G=1000
    groups x 4 subjects x 10 obs, p=3 (15,009 parameters), 512 chains,
    1000/16384, adaptive RW-MH on beta_s with the fused step, the
    inverse-gamma tau priors (exact conjugate draws of both log tau
    levels), conjugate beta_g and mu, the tau_g Laplace interweave (4 a
    sweep) and the tau_s interweave (2 a sweep), streamed R-hat over every
    parameter."""
    data, _ = synth_poisson3(seed + 3000, G=groups or 1000,
                             subjects_per_group=4, n=10, p=3, device=device)
    model = make_nested_poisson(data, tau_prior="invgamma")
    cfg = SamplerConfig(
        kernel=KernelConfig(fused_accept=True),
        run=RunConfig(
            chains=512, warmup=1000, draws=16384, seed=seed,
            segment_size=1024,
            collect={"mu": None, "log_tau_g": None, "log_tau_s": None,
                     "beta_g": 8, "beta_s": 8},
            full_rhat=True, log_every_segment=False,
        ),
    )
    return model, data, cfg


def _nested_poisson_1k_algorithm(algorithm: str):
    def preset(seed: int, device, groups):
        model, data, cfg = _nested_poisson_1k(seed, device, groups)
        return model, data, dataclasses.replace(
            cfg, kernel=dataclasses.replace(cfg.kernel, algorithm=algorithm)
        )
    preset.__doc__ = (
        f"Config 3 with {algorithm} on beta_s (nestmc/presets.py "
        f"_nested_poisson_1k_{algorithm}): the same data and schedule; the "
        "tau_s interweave follows the cache (Langevin for MALA, the "
        "Laplace move for Newton, frozen in sampling)."
    )
    return preset


PRESETS = {
    "judged": _judged,
    "mala-100k": _mala_100k,
    "hier-logistic-100-rw": _hier_logistic_100_rw,
    "nested-poisson-1k": _nested_poisson_1k,
    "nested-poisson-1k-mala": _nested_poisson_1k_algorithm("mala"),
    "nested-poisson-1k-newton": _nested_poisson_1k_algorithm("newton"),
}


def get_preset(name: str, seed: int = 0, device="cuda",
               groups: int | None = None):
    """(model, data, SamplerConfig) of a named preset on ``device``;
    ``groups`` overrides its number of groups G."""
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name](seed, device, groups)
