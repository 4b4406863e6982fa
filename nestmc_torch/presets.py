"""Named presets of the port: (model, data, SamplerConfig) from a seed.

Port of the three :mod:`nestmc.presets` entries the port runs, at full
width (no ``scale``): the judged config of bench.py, config 5
(``mala-100k``) and the RW-MH state of config 2
(``hier-logistic-100-rw``). Data come from the port's numpy
``synth_logistic`` with the reference's seed offsets: the same generative
model, other draws. The JAX presets' sharding is dropped (one device) and
their TPU measurements in comments are not carried over. ``groups``
overrides G for small test runs only.
"""

from __future__ import annotations

from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.models import make_hier_logistic, synth_logistic


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


PRESETS = {
    "judged": _judged,
    "mala-100k": _mala_100k,
    "hier-logistic-100-rw": _hier_logistic_100_rw,
}


def get_preset(name: str, seed: int = 0, device="cuda",
               groups: int | None = None):
    """(model, data, SamplerConfig) of a named preset on ``device``."""
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name](seed, device, groups)
