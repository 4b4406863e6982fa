"""Hierarchical logistic regression — the judged benchmark model.

    y_ij ~ Bernoulli(sigmoid(x_ij . beta_j))     i obs in group j
    beta_j ~ N(mu, diag(tau^2))                  group-level coefficients
    mu_k ~ N(0, prior_mu_scale^2)
    tau_k^2 ~ InvGamma(tau_ig_shape, tau_ig_scale)

Port of :mod:`nestmc.models.hier_logistic` for the Newton-MH path: padded
data, the inverse-gamma tau prior (exact conjugate draws of mu and
log tau), the fused Newton-MH beta update (ops/cuda/newton_accept) and the
joint (mu, log tau) Laplace interweaving move in Newton mode. The obs
passes run the CUDA kernels on CUDA tensors and their plain versions on
CPU tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nestmc_torch.data import NestedData, from_numpy
from nestmc_torch.distributions import log_scale_guard
from nestmc_torch.model import Block, ModelSpec
from nestmc_torch.ops.cuda.loglik_logistic import (
    logistic_logp_grad,
    logistic_logp_grad_hess,
)
from nestmc_torch.ops.cuda.newton_accept import fused_newton_logistic_step
from nestmc_torch.ops.smallchol import (
    chol_packed,
    half_logdet,
    lt_vec,
    pack_diag,
    packed_index,
    solve_upper_t,
    spd_solve,
)

_HALFNORMAL = (
    "tau_prior='halfnormal' (MH on log tau) is not ported yet "
    "(ROADMAP Queue 1: the rest of the logistic family)"
)
_RAGGED = "ragged data is not ported yet (ROADMAP Queue 1, item 10)"


def make_hier_logistic(
    data,
    prior_mu_scale: float = 5.0,
    prior_tau_scale: float = 2.0,
    loglik_impl: str = "auto",
    tau_prior: str = "halfnormal",
    tau_ig_shape: float = 2.0,
    tau_ig_scale: float = 0.5,
    asis_repeats: int = 1,
) -> ModelSpec:
    """Same arguments as nestmc.models.make_hier_logistic. Only
    tau_prior='invgamma' on padded data runs; prior_tau_scale belongs to
    the half-normal prior and is unused."""
    if not isinstance(data, NestedData):
        raise NotImplementedError(_RAGGED)
    if loglik_impl == "pallas-segment":
        raise NotImplementedError(
            "loglik_impl='pallas-segment' is not ported yet "
            "(ROADMAP Queue 2, item 10)"
        )
    if loglik_impl != "auto":
        raise ValueError(f"loglik_impl={loglik_impl!r}: the port has 'auto'")
    if tau_prior == "halfnormal":
        raise NotImplementedError(_HALFNORMAL)
    if tau_prior != "invgamma":
        raise ValueError(tau_prior)
    G = data.num_groups
    p = data.num_covariates
    q = 2 * p                                       # joint (mu, lt) dim
    a_ig, b_ig = tau_ig_shape, tau_ig_scale
    lp_const = a_ig * math.log(b_ig) - math.lgamma(a_ig)
    inv_s0_2 = 1.0 / prior_mu_scale**2
    dev = data.device
    hidx = torch.tensor(
        [[packed_index(i, j) for j in range(p)] for i in range(p)],
        device=dev,
    )
    qidx = torch.tensor(
        [i * q + j for i in range(q) for j in range(i + 1)], device=dev
    )
    eye_p = torch.eye(p, device=dev)

    def _tau_logprior(lt):
        """log p(log tau) with the Jacobian: tau^2 ~ IG(a, b)."""
        return (
            lp_const - 2.0 * (a_ig + 1.0) * lt - b_ig * torch.exp(-2.0 * lt)
            + math.log(2.0) + 2.0 * lt
        )

    def _tau_logprior_grad(lt):
        return -2.0 * a_ig + 2.0 * b_ig * torch.exp(-2.0 * lt)

    def _tau_logprior_metric(lt):
        return 4.0 * b_ig * torch.exp(-2.0 * lt)

    def lik_value_and_grad(value, data):
        return logistic_logp_grad(value, data.x, data.y, data.mask)

    def lik_value_grad_hess(value, data):
        return logistic_logp_grad_hess(value, data.x, data.y, data.mask)

    def gprior_vgh(value, state, data):
        """Gaussian group prior: value (C, G), grad (C, G, p) and the
        packed constant precision diag(1/tau^2) as (C, 1, T)."""
        mu = state["mu"][:, None, :]
        inv_tau2 = torch.exp(-2.0 * state["log_tau"])
        diff = value - mu
        it2 = inv_tau2[:, None, :]
        gp_val = torch.sum(
            -0.5 * diff * diff * it2 + 0.5 * torch.log(it2)
            - 0.9189385332046727,
            dim=-1,
        )
        return gp_val, -diff * it2, pack_diag(inv_tau2, p)[:, None, :]

    def fused_newton_beta_update(rng, position, cache, log_scale, data,
                                 frozen=False, rhat_fold=None):
        """One fused Newton-MH update of beta (ops/cuda/newton_accept)."""
        c = cache.get("beta")
        if isinstance(c, dict) and "h" in c:
            v, g, h = c["v"], c["g"], c["h"]
        else:
            v, g, h = lik_value_grad_hess(position["beta"], data)
        out = fused_newton_logistic_step(
            position["beta"], v, g, h, log_scale,
            position["mu"], position["log_tau"], data.x, data.y, data.mask,
            rng=rng, frozen=frozen, rhat_fold=rhat_fold,
        )
        nb, nv, ng, nh, alpha = out[:5]
        new_cache = {"v": nv, "g": ng, "h": nh}
        if rhat_fold is not None:
            return nb, new_cache, alpha, (out[5], out[6])
        return nb, new_cache, alpha

    def _asis_joint_grad(g_lik, d, mu_at, lt_at):
        """(C, 2p) gradient of the z-fixed target F(mu, lt)."""
        return torch.cat([
            g_lik.sum(dim=1) - mu_at * inv_s0_2,
            (g_lik * d).sum(dim=1) + _tau_logprior_grad(lt_at),
        ], dim=-1)

    def _asis_joint_metric(h_packed, d, lt_at):
        """Packed (C, q(q+1)/2) Gauss-Newton metric of the z-fixed target,
        theta = (mu, lt): sum_g J_g^T (-H_g) J_g with J_g = [I, diag(d_g)]
        plus the prior precision (nestmc: _asis_joint_metric)."""
        H = h_packed[..., hidx]                          # (C, G, p, p)
        dk = d[..., :, None]
        m_mm = H.sum(dim=1) + inv_s0_2 * eye_p
        m_lm = (H * dk).sum(dim=1)                       # [lt_k, mu_l]
        m_ll = (H * dk * d[..., None, :]).sum(dim=1) + torch.diag_embed(
            _tau_logprior_metric(lt_at)
        )
        M = torch.cat([
            torch.cat([m_mm, m_lm.transpose(-1, -2)], dim=-1),
            torch.cat([m_lm, m_ll], dim=-1),
        ], dim=-2)
        return M.reshape(M.shape[0], q * q)[:, qidx]

    def asis_tau_move(rng, position, cache, scale, data, frozen=False):
        """Joint (mu, log tau) interweaving move (Yu & Meng 2011) in Newton
        mode: a Laplace proposal N(theta + M^-1 F', M^-1) on the z-fixed
        target with z = (beta - mu)/tau held, M the Gauss-Newton metric
        from the carried Hessian; parameter-free, so ``scale`` is unused.
        The eval pass computes the Hessian in refresh mode and only
        (value, grad) when frozen."""
        lik_cache = cache.get("beta")
        if not (isinstance(lik_cache, dict) and "h" in lik_cache):
            raise NotImplementedError(
                "the RW and MALA ASIS modes are not ported yet "
                "(ROADMAP Queue 1: the rest of the logistic family)"
            )
        beta, mu, lt = position["beta"], position["mu"], position["log_tau"]
        C = lt.shape[0]
        diff = beta - mu[:, None, :]                     # tau z, (C, G, p)
        eps_q = rng.normal((C, q))
        f_old = _asis_joint_grad(lik_cache["g"], diff, mu, lt)
        L_old = chol_packed(_asis_joint_metric(lik_cache["h"], diff, lt), q)
        th_old = torch.cat([mu, lt], dim=-1)
        mean_old = th_old + spd_solve(L_old, f_old, q)
        th_new = mean_old + solve_upper_t(L_old, eps_q, q)
        mu_new, lt_new = th_new[:, :p], th_new[:, p:]
        ratio = torch.exp(lt_new - lt)[:, None, :]
        diff_new = diff * ratio                          # e^{lt'} z
        beta_new = mu_new[:, None, :] + diff_new
        lik_old = lik_cache["v"]
        if frozen:
            lik_new, grad_new = lik_value_and_grad(beta_new, data)
            hess_new = lik_cache["h"]
        else:
            lik_new, grad_new, hess_new = lik_value_grad_hess(beta_new, data)
        f_new = _asis_joint_grad(grad_new, diff_new, mu_new, lt_new)
        L_new = chol_packed(_asis_joint_metric(hess_new, diff_new, lt_new), q)
        mean_new = th_new + spd_solve(L_new, f_new, q)
        w_rev = lt_vec(L_new, th_old - mean_new, q)
        q_corr = (
            -0.5 * torch.sum(w_rev * w_rev, dim=-1)
            + half_logdet(L_new, q)
            + 0.5 * torch.sum(eps_q * eps_q, dim=-1)
            - half_logdet(L_old, q)
        )
        prior_delta = torch.sum(
            _tau_logprior(lt_new) + log_scale_guard(lt_new)
            - _tau_logprior(lt),
            dim=-1,
        ) + torch.sum(-0.5 * (mu_new * mu_new - mu * mu) * inv_s0_2, dim=-1)
        log_alpha = (
            torch.sum(lik_new - lik_old, dim=-1) + prior_delta + q_corr
        )
        logu = rng.log_uniform((C,))
        accept = logu < log_alpha
        acc2 = accept[:, None]
        acc3 = accept[:, None, None]
        pos_up = {
            "beta": torch.where(acc3, beta_new, beta),
            "log_tau": torch.where(acc2, lt_new, lt),
            "mu": torch.where(acc2, mu_new, mu),
        }
        cache_up = {"beta": {
            "v": torch.where(acc2, lik_new, lik_old),
            "g": torch.where(acc3, grad_new, lik_cache["g"]),
            "h": lik_cache["h"] if frozen
            else torch.where(acc3, hess_new, lik_cache["h"]),
        }}
        alpha = torch.where(
            torch.isnan(log_alpha), torch.zeros_like(log_alpha),
            torch.exp(log_alpha.clamp_max(0.0)),
        )
        return pos_up, cache_up, alpha

    def gibbs_mu(rng, state, data):
        """Exact conjugate draw of mu | beta, tau per coordinate."""
        s1 = state["beta"].sum(dim=1)
        inv_tau2 = torch.exp(-2.0 * state["log_tau"])
        prec = G * inv_tau2 + inv_s0_2
        mean = s1 * inv_tau2 / prec
        return mean + rng.normal(mean.shape) / torch.sqrt(prec)

    def gibbs_log_tau(rng, state, data):
        """Exact conjugate draw: tau_k^2 | beta, mu ~ InvGamma(a + G/2,
        b + quad_k/2) as rate / Gamma(shape), returned as log tau and
        clipped to [-12, 12] (the log_scale_guard support)."""
        beta, mu = state["beta"], state["mu"]
        s1, s2 = beta.sum(dim=1), (beta * beta).sum(dim=1)
        quad = s2 - 2.0 * mu * s1 + G * mu * mu
        rate = b_ig + 0.5 * quad
        g = rng.gamma(a_ig + 0.5 * G, quad.shape)
        return torch.clamp(
            0.5 * (torch.log(rate) - torch.log(g)), -12.0, 12.0
        )

    def init_state(rng, data, chains):
        return {
            "beta": 0.5 * rng.normal((chains, G, p)),
            "mu": 0.5 * rng.normal((chains, p)),
            "log_tau": -0.5 + 0.3 * rng.normal((chains, p)),
        }

    return ModelSpec(
        name="hier_logistic",
        blocks=(
            Block("beta", (G, p), units=G, init_scale=0.3),
            Block("mu", (p,), units=p, init_scale=0.2),
            Block("log_tau", (p,), units=p, init_scale=0.2, repeats=4),
        ),
        init_state=init_state,
        gibbs_draws={"mu": gibbs_mu, "log_tau": gibbs_log_tau},
        joint_moves=(
            {"asis_tau": asis_tau_move} if asis_repeats > 0 else {}
        ),
        joint_move_repeats={"asis_tau": max(1, int(asis_repeats))},
        joint_move_init_scale={
            "asis_tau": 2.38 / math.sqrt(p * max(G, 1)),
        },
        joint_move_init_scale_grad={"asis_tau": 1.0},
        joint_move_target_accept={"asis_tau": "auto"},
        fused_updates_newton={"beta": fused_newton_beta_update},
        cond_cached_newton={"beta": (lik_value_grad_hess, gprior_vgh)},
    )


def synth_logistic(seed, G: int = 100, n: int = 50, p: int = 4,
                   ragged: bool = False, device="cpu"):
    """Synthetic hierarchical-logistic data from the reference's generative
    model, drawn with a numpy Generator seeded by ``seed``. Returns
    (NestedData on ``device``, truth dict of numpy arrays)."""
    if ragged:
        raise NotImplementedError(_RAGGED)
    r = np.random.default_rng(seed)
    mu = 0.5 * r.standard_normal(p)
    tau = 0.3 + 0.3 * np.abs(r.standard_normal(p))
    beta = mu + tau * r.standard_normal((G, p))
    x = r.standard_normal((G, n, p)).astype(np.float32)
    x[:, :, 0] = 1.0  # intercept column
    eta = np.einsum("gnp,gp->gn", x, beta)
    y = (r.random((G, n)) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float32)
    data = from_numpy(x, y, np.ones((G, n), np.float32), device=device)
    return data, {"mu": mu, "tau": tau, "beta": beta}
