"""Linear-Gaussian hierarchical model with a closed-form posterior.

    y_ij ~ N(theta_j, sigma^2)        sigma known
    theta_j ~ N(mu, tau^2)            tau known
    mu ~ N(m0, s0^2)

Port of :mod:`nestmc.models.conjugate`. Everything is jointly Gaussian, so
the exact posterior mean and variance of mu and of every theta_j have a
closed form (:func:`analytic_hier_normal_posterior`): the exactness anchor
of the sampler, whose moments must land within z x MCSE of it
(tests/test_torch_exactness.py). Both blocks run the unfused RW-MH update
in plain PyTorch; no kernel serves this model.
"""

from __future__ import annotations

import numpy as np
import torch

from nestmc_torch.data import NestedData, from_numpy
from nestmc_torch.distributions import logpdf_normal
from nestmc_torch.model import Block, ModelSpec


def make_hier_normal_known_scales(
    data: NestedData,
    sigma: float = 1.0,
    tau: float = 1.0,
    m0: float = 0.0,
    s0: float = 3.0,
) -> ModelSpec:
    """Same arguments as nestmc.models.make_hier_normal_known_scales."""
    G = data.num_groups

    def _parts(state, d):
        theta = state["theta"]                               # (C, G)
        lik = logpdf_normal(d.y, theta[:, :, None], sigma)   # (C, G, n)
        lik = torch.sum(lik * d.mask, dim=-1)
        gprior = logpdf_normal(theta, state["mu"][:, None], tau)
        return lik, gprior

    def cond(name, value, state, d):
        state = {**state, name: value}
        lik, gprior = _parts(state, d)
        if name == "theta":
            return lik + gprior
        if name == "mu":
            return torch.sum(gprior, dim=-1) + logpdf_normal(
                state["mu"], m0, s0
            )
        raise KeyError(name)

    def joint(state, d):
        lik, gprior = _parts(state, d)
        return torch.sum(lik + gprior, dim=-1) + logpdf_normal(
            state["mu"], m0, s0
        )

    def init_state(rng, d, chains):
        return {"theta": rng.normal((chains, G)), "mu": rng.normal((chains,))}

    def prior_sample(rng, d, chains):
        mu = m0 + s0 * rng.normal((chains,))
        theta = mu[:, None] + tau * rng.normal((chains, G))
        return {"theta": theta, "mu": mu}

    def sample_data(rng, state, d):
        y = state["theta"][0][:, None] + sigma * rng.normal(d.y.shape)
        return NestedData(y=y, mask=d.mask, sizes=d.sizes, x=d.x,
                          extra=d.extra)

    return ModelSpec(
        name="hier_normal_known_scales",
        blocks=(
            Block("theta", (G,), units=G, init_scale=1.0),
            Block("mu", (), init_scale=1.0),
        ),
        init_state=init_state,
        cond_logdensity=cond,
        joint_logdensity=joint,
        prior_sample=prior_sample,
        sample_data=sample_data,
    )


def synth_hier_normal(
    seed, G: int = 20, n: int = 10, sigma: float = 1.0, tau: float = 1.0,
    m0: float = 0.0, s0: float = 3.0, device="cuda",
) -> NestedData:
    """Data from the model's generative process, drawn with a numpy
    Generator seeded by ``seed``, as NestedData on ``device`` (the card
    unless the caller asks for another)."""
    r = np.random.default_rng(seed)
    mu = m0 + s0 * r.standard_normal()
    theta = mu + tau * r.standard_normal(G)
    y = theta[:, None] + sigma * r.standard_normal((G, n))
    return from_numpy(None, y, np.ones((G, n)), device=device)


def analytic_hier_normal_posterior(data, sigma: float, tau: float,
                                   m0: float, s0: float) -> dict:
    """Exact posterior moments of (mu, theta) in float64 numpy: mu_mean,
    mu_var, theta_mean (G,), theta_var (G,). ``data`` has y and mask
    (G, n), as tensors or arrays."""
    y = np.asarray(_host(data.y), np.float64)
    mask = np.asarray(_host(data.mask), np.float64)
    n = mask.sum(axis=1)
    ybar = (y * mask).sum(axis=1) / n
    # marginally ybar_j | mu ~ N(mu, sigma^2/n_j + tau^2)
    v_j = sigma**2 / n + tau**2
    mu_var = 1.0 / (1.0 / s0**2 + np.sum(1.0 / v_j))
    mu_mean = mu_var * (m0 / s0**2 + np.sum(ybar / v_j))
    # theta_j | mu, y ~ N((a_j ybar_j + b mu) / (a_j + b), 1 / (a_j + b))
    a = n / sigma**2
    b = 1.0 / tau**2
    w = b / (a + b)
    return {
        "mu_mean": mu_mean,
        "mu_var": mu_var,
        "theta_mean": (a * ybar + b * mu_mean) / (a + b),
        "theta_var": 1.0 / (a + b) + w**2 * mu_var,
    }


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else a
