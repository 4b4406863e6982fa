"""Hierarchical normal means model ("8 schools"), BASELINE config 1.

    y_j ~ N(theta_j, sigma_j^2)   sigma_j known, j = 1..G
    theta_j ~ N(mu, tau^2)
    mu ~ N(0, prior_mu_scale^2),  tau ~ HalfCauchy(prior_tau_scale)

Port of :mod:`nestmc.models.eight_schools`. The default parameterisation
is non-centred: theta_j = mu + tau z_j with z_j ~ N(0, 1) sampled as the
group block, and theta exposed as a derived quantity, so users see the
same parameters either way; ``centered=True`` samples theta itself. tau is
sampled as log tau with its Jacobian (and, non-centred, the
log_scale_guard). Blocks: z (or theta; G units, one batched (C, G) MH
update), then mu, then log_tau, all by the unfused updates in plain
PyTorch; no kernel serves this model.
"""

from __future__ import annotations

import numpy as np
import torch

from nestmc_torch.data import NestedData, from_numpy
from nestmc_torch.distributions import (
    log_scale_guard,
    logpdf_halfcauchy,
    logpdf_normal,
)
from nestmc_torch.model import Block, ModelSpec

Y = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
SIGMA = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)


def eight_schools_data(device="cuda") -> NestedData:
    """The classical Rubin (1981) 8-schools data on ``device`` (the card
    unless the caller asks for another): y (8, 1), the known scales as
    extra["sigma"] (8,)."""
    return from_numpy(None, np.array(Y)[:, None], np.ones((8, 1)),
                      device=device, extra={"sigma": np.array(SIGMA)})


def _half_cauchy(rng, scale, shape):
    """|N(0,1) / N(0,1)| x scale: an exact half-Cauchy draw."""
    return scale * torch.abs(rng.normal(shape) / rng.normal(shape))


def _make_noncentered(data, prior_mu_scale, prior_tau_scale):
    G = data.num_groups

    def _theta(state):
        tau = torch.exp(state["log_tau"])[:, None]
        return state["mu"][:, None] + tau * state["z"]

    def _lik(state, d):
        y = d.y[..., 0]                        # (G,), or (C, G) batched
        return logpdf_normal(y, _theta(state), d.extra["sigma"])  # (C, G)

    def cond(name, value, state, d):
        state = {**state, name: value}
        if name == "z":
            return _lik(state, d) + logpdf_normal(state["z"])
        if name == "mu":
            return (torch.sum(_lik(state, d), dim=-1)
                    + logpdf_normal(state["mu"], 0.0, prior_mu_scale))
        if name == "log_tau":
            lt = state["log_tau"]
            return (
                torch.sum(_lik(state, d), dim=-1)
                + logpdf_halfcauchy(torch.exp(lt), prior_tau_scale)
                + lt + log_scale_guard(lt)
            )
        raise KeyError(name)

    def joint(state, d):
        lt = state["log_tau"]
        return (
            torch.sum(_lik(state, d) + logpdf_normal(state["z"]), dim=-1)
            + logpdf_normal(state["mu"], 0.0, prior_mu_scale)
            + logpdf_halfcauchy(torch.exp(lt), prior_tau_scale) + lt
        )

    def init_state(rng, d, chains):
        return {
            "z": rng.normal((chains, G)),
            "mu": d.y[:, 0].mean() + 5.0 * rng.normal((chains,)),
            "log_tau": np.log(5.0) + 0.5 * rng.normal((chains,)),
        }

    def prior_sample(rng, d, chains):
        mu = prior_mu_scale * rng.normal((chains,))
        tau = _half_cauchy(rng, prior_tau_scale, (chains,))
        z = rng.normal((chains, G))
        return {"z": z, "mu": mu, "log_tau": torch.log(tau)}

    def sample_data(rng, state, d):
        y = _theta(state)[0] + d.extra["sigma"] * rng.normal((G,))
        return NestedData(y=y[:, None], mask=d.mask, sizes=d.sizes, x=d.x,
                          extra=d.extra)

    return ModelSpec(
        name="eight_schools",
        blocks=(
            Block("z", (G,), units=G, init_scale=1.0),
            Block("mu", (), init_scale=5.0),
            Block("log_tau", (), init_scale=0.5),
        ),
        init_state=init_state,
        cond_logdensity=cond,
        joint_logdensity=joint,
        prior_sample=prior_sample,
        sample_data=sample_data,
        derived={"theta": _theta},
    )


def _make_centered(data, prior_mu_scale, prior_tau_scale):
    G = data.num_groups

    def _parts(state, d):
        theta = state["theta"]
        tau = torch.exp(state["log_tau"])[:, None]
        lik = logpdf_normal(d.y[..., 0], theta, d.extra["sigma"])
        gprior = logpdf_normal(theta, state["mu"][:, None], tau)
        return lik, gprior

    def cond(name, value, state, d):
        state = {**state, name: value}
        lik, gprior = _parts(state, d)
        if name == "theta":
            return lik + gprior
        if name == "mu":
            return (torch.sum(gprior, dim=-1)
                    + logpdf_normal(state["mu"], 0.0, prior_mu_scale))
        if name == "log_tau":
            lt = state["log_tau"]
            return (torch.sum(gprior, dim=-1)
                    + logpdf_halfcauchy(torch.exp(lt), prior_tau_scale) + lt)
        raise KeyError(name)

    def joint(state, d):
        lik, gprior = _parts(state, d)
        lt = state["log_tau"]
        return (
            torch.sum(lik + gprior, dim=-1)
            + logpdf_normal(state["mu"], 0.0, prior_mu_scale)
            + logpdf_halfcauchy(torch.exp(lt), prior_tau_scale) + lt
        )

    def init_state(rng, d, chains):
        y = d.y[:, 0]
        return {
            "theta": y + 5.0 * rng.normal((chains, G)),
            "mu": y.mean() + 5.0 * rng.normal((chains,)),
            "log_tau": np.log(5.0) + 0.5 * rng.normal((chains,)),
        }

    def prior_sample(rng, d, chains):
        mu = prior_mu_scale * rng.normal((chains,))
        tau = _half_cauchy(rng, prior_tau_scale, (chains,))
        theta = mu[:, None] + tau[:, None] * rng.normal((chains, G))
        return {"theta": theta, "mu": mu, "log_tau": torch.log(tau)}

    def sample_data(rng, state, d):
        y = state["theta"][0] + d.extra["sigma"] * rng.normal((G,))
        return NestedData(y=y[:, None], mask=d.mask, sizes=d.sizes, x=d.x,
                          extra=d.extra)

    return ModelSpec(
        name="eight_schools_centered",
        blocks=(
            Block("theta", (G,), units=G, init_scale=5.0),
            Block("mu", (), init_scale=5.0),
            Block("log_tau", (), init_scale=0.5),
        ),
        init_state=init_state,
        cond_logdensity=cond,
        joint_logdensity=joint,
        prior_sample=prior_sample,
        sample_data=sample_data,
    )


def make_eight_schools(
    data: NestedData | None = None,
    prior_mu_scale: float = 10.0,
    prior_tau_scale: float = 5.0,
    centered: bool = False,
    device="cuda",
) -> tuple:
    """(ModelSpec, data) as nestmc.models.make_eight_schools; ``data``
    defaults to :func:`eight_schools_data` on ``device``."""
    if data is None:
        data = eight_schools_data(device)
    maker = _make_centered if centered else _make_noncentered
    return maker(data, prior_mu_scale, prior_tau_scale), data
