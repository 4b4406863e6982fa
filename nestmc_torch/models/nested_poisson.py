"""Three-level nested Poisson GLMM (config 3).

    y_si  ~ Poisson(exp(x_si . beta_s))        obs i within subject s
    beta_s ~ N(beta_{g(s)}, diag(tau_s^2))      subjects within groups
    beta_g ~ N(mu, diag(tau_g^2))
    mu_k ~ N(0, prior_mu_scale^2); tau_* ~ HalfNormal(prior_tau_scale)
      or tau_*^2 ~ InvGamma(tau_ig_shape, tau_ig_scale)

Port of :mod:`nestmc.models.nested_poisson` on padded three-level data
(:class:`nestmc_torch.data.NestedData3`): both tau priors (half-normal: MH
blocks on log tau; inverse-gamma: exact conjugate draws), the exact
conjugate mu and beta_g draws, the fused RW-MH, MALA and Newton-MH subject
updates (ops/cuda/poisson_accept) and the two interweaving moves:
tau_g's Laplace move, which touches no data, and tau_s's move in its RW,
Langevin (gradient cache) and Laplace (Newton cache, refresh or frozen)
modes, and the prior and data simulators of the calibration tiers. The
obs passes run the CUDA kernels on CUDA tensors and their plain versions
on CPU tensors. Subject -> group sums are deterministic
(NestedData3.group_sum). The model reads S, G and p from ``data`` once, so
its hooks also take data whose y carries a chains axis, (C, S, n) (the
Geweke tier), with x and mask shared.

Not ported yet (ROADMAP Queue 1, WAIC and LOO): the per-unit logliks
(``derived``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from nestmc_torch.data import NestedData3, from_numpy3
from nestmc_torch.distributions import (
    log_scale_guard,
    logpdf_halfnormal,
    logpdf_normal,
)
from nestmc_torch.model import Block, ModelSpec
from nestmc_torch.ops.cuda.loglik_poisson import (
    poisson_logp_grad,
    poisson_logp_grad_hess,
    poisson_loglik,
)
from nestmc_torch.ops.cuda.poisson_accept import (
    fused_mala_poisson_step,
    fused_newton_poisson_step,
    fused_rwmh_poisson_step,
)
from nestmc_torch.ops.loglik import poisson_const
from nestmc_torch.ops.smallchol import (
    chol_packed,
    half_logdet,
    lt_vec,
    pack_diag,
    solve_upper_t,
    spd_solve,
)

_LOG_2PI = 1.8378770664093453


def make_nested_poisson(
    data: NestedData3,
    prior_mu_scale: float = 2.0,
    prior_tau_scale: float = 1.0,
    loglik_impl: str = "auto",
    tau_prior: str = "halfnormal",
    tau_ig_shape: float = 2.0,
    tau_ig_scale: float = 0.25,
    asis_tau_g_repeats: int = 4,
    asis_tau_s_repeats: int = 2,
) -> ModelSpec:
    """Same arguments as nestmc.models.make_nested_poisson (loglik_impl
    'auto' only)."""
    if not isinstance(data, NestedData3):
        raise TypeError("make_nested_poisson takes NestedData3")
    if loglik_impl != "auto":
        raise ValueError(f"loglik_impl={loglik_impl!r}: the port has 'auto'")
    if tau_prior not in ("halfnormal", "invgamma"):
        raise ValueError(tau_prior)
    conj_tau = tau_prior == "invgamma"
    S = data.num_subjects
    G = data.num_groups
    p = data.num_covariates
    a_ig, b_ig = tau_ig_shape, tau_ig_scale
    lp_const = a_ig * math.log(b_ig) - math.lgamma(a_ig)
    inv_s0_2 = 1.0 / prior_mu_scale**2
    inv_S2 = 1.0 / prior_tau_scale**2
    # the parameter-free -sum_i mask lgamma(y + 1) per subject, once
    const = poisson_const(data.y, data.mask)
    n_obs = int(round(float(data.mask.sum())))
    ii = torch.tensor([i for i in range(p) for j in range(i + 1)],
                      device=data.device)
    jj = torch.tensor([j for i in range(p) for j in range(i + 1)],
                      device=data.device)

    def _const(d):
        return const if d is data else poisson_const(d.y, d.mask)

    def _lik(beta_s, d):
        return poisson_loglik(beta_s, d.x, d.y, d.mask, _const(d))

    def lik_value_and_grad(value, d):
        return poisson_logp_grad(value, d.x, d.y, d.mask, _const(d))

    def lik_value_grad_hess(value, d):
        return poisson_logp_grad_hess(value, d.x, d.y, d.mask, _const(d))

    def _tau_logprior(lt):
        """log p(log tau) elementwise, with the Jacobian to log space."""
        if conj_tau:
            # tau^2 ~ IG(a, b); |d tau^2 / d log tau| = 2 e^{2 lt}
            return (
                lp_const - 2.0 * (a_ig + 1.0) * lt
                - b_ig * torch.exp(-2.0 * lt) + math.log(2.0) + 2.0 * lt
            )
        return logpdf_halfnormal(torch.exp(lt), prior_tau_scale) + lt

    def _tau_logprior_grad(lt):
        if conj_tau:
            return -2.0 * a_ig + 2.0 * b_ig * torch.exp(-2.0 * lt)
        return 1.0 - torch.exp(2.0 * lt) * inv_S2

    def _tau_logprior_metric(lt):
        """-d^2/d(log tau)^2 of _tau_logprior: positive for both priors."""
        if conj_tau:
            return 4.0 * b_ig * torch.exp(-2.0 * lt)
        return 2.0 * torch.exp(2.0 * lt) * inv_S2

    def _bgs(position, d):
        """beta_g gathered to subjects, (C, S, p)."""
        return d.to_subjects(position["beta_g"])

    def _sprior(state, d):
        """(C, S) subject prior beta_s | beta_g, tau_s."""
        tau_s = torch.exp(state["log_tau_s"])[:, None, :]
        return torch.sum(
            logpdf_normal(state["beta_s"], _bgs(state, d), tau_s), dim=-1
        )

    def _gprior(state):
        """(C, G) group prior beta_g | mu, tau_g."""
        tau_g = torch.exp(state["log_tau_g"])[:, None, :]
        return torch.sum(
            logpdf_normal(state["beta_g"], state["mu"][:, None, :], tau_g),
            dim=-1,
        )

    def _pprior(state):
        return (
            torch.sum(logpdf_normal(state["mu"], 0.0, prior_mu_scale), dim=-1)
            + torch.sum(_tau_logprior(state["log_tau_s"]), dim=-1)
            + torch.sum(_tau_logprior(state["log_tau_g"]), dim=-1)
        )

    def _suff_g(state):
        """(sum_g beta_g, sum_g beta_g^2), each (C, p)."""
        bg = state["beta_g"]
        return bg.sum(dim=1), (bg * bg).sum(dim=1)

    def _dev2_s(state, d):
        """sum_s (beta_s - beta_g(s))^2, (C, p)."""
        dev = state["beta_s"] - _bgs(state, d)
        return (dev * dev).sum(dim=1)

    def cond(name, value, state, d):
        state = {**state, name: value}
        if name == "beta_s":
            return _lik(state["beta_s"], d) + _sprior(state, d)
        if name == "beta_g":
            return d.group_sum(_sprior(state, d)) + _gprior(state)
        if name in ("mu", "log_tau_g"):
            s1, s2 = _suff_g(state)
            mu, lt = state["mu"], state["log_tau_g"]
            quad = s2 - 2.0 * mu * s1 + G * mu * mu
            base = (
                -0.5 * quad * torch.exp(-2.0 * lt) - G * lt
                - 0.5 * G * _LOG_2PI
            )                                           # (C, p)
            if name == "mu":
                return base + logpdf_normal(mu, 0.0, prior_mu_scale)
            return base + _tau_logprior(lt) + log_scale_guard(lt)
        if name == "log_tau_s":
            lt = state["log_tau_s"]
            return (
                -0.5 * _dev2_s(state, d) * torch.exp(-2.0 * lt) - S * lt
                - 0.5 * S * _LOG_2PI + _tau_logprior(lt) + log_scale_guard(lt)
            )
        raise KeyError(name)

    def sprior_value_and_grad(value, state, d):
        """Closed-form subject prior value (C, S) and gradient at value."""
        inv_tau2 = torch.exp(-2.0 * state["log_tau_s"])[:, None, :]
        diff = value - _bgs(state, d)
        val = torch.sum(
            -0.5 * diff * diff * inv_tau2 + 0.5 * torch.log(inv_tau2)
            - 0.9189385332046727,
            dim=-1,
        )
        return val, -diff * inv_tau2

    def sprior_vgh(value, state, d):
        """The subject prior's value, gradient and packed constant
        precision diag(1/tau_s^2) as (C, 1, T)."""
        val, grad = sprior_value_and_grad(value, state, d)
        inv_ts2 = torch.exp(-2.0 * state["log_tau_s"])
        return val, grad, pack_diag(inv_ts2, p)[:, None, :]

    def fused_rwmh_beta_s_update(rng, position, cache, log_scale, d):
        """One fused RW-MH update of beta_s (ops/cuda/poisson_accept)."""
        lik_cache = cache.get("beta_s")
        if lik_cache is None:
            lik_cache = _lik(position["beta_s"], d)
        return fused_rwmh_poisson_step(
            position["beta_s"], lik_cache, log_scale, _bgs(position, d),
            position["log_tau_s"], d.x, d.y, d.mask, rng=rng,
            const=_const(d),
        )

    def fused_mala_beta_s_update(rng, position, cache, log_scale, d):
        """One fused MALA update of beta_s (ops/cuda/poisson_accept)."""
        c = cache.get("beta_s")
        if isinstance(c, dict):
            v, g = c["v"], c["g"]
        else:
            v, g = lik_value_and_grad(position["beta_s"], d)
        nb, nv, ng, alpha = fused_mala_poisson_step(
            position["beta_s"], v, g, log_scale, _bgs(position, d),
            position["log_tau_s"], d.x, d.y, d.mask, rng=rng,
            const=_const(d),
        )
        return nb, {"v": nv, "g": ng}, alpha

    def fused_newton_beta_s_update(rng, position, cache, log_scale, d,
                                   frozen=False):
        """One fused Newton-MH update of beta_s (ops/cuda/poisson_accept);
        frozen: the carried Hessian is a constant metric."""
        c = cache.get("beta_s")
        if isinstance(c, dict) and "h" in c:
            v, g, h = c["v"], c["g"], c["h"]
        else:
            v, g, h = lik_value_grad_hess(position["beta_s"], d)
        nb, nv, ng, nh, alpha = fused_newton_poisson_step(
            position["beta_s"], v, g, h, log_scale, _bgs(position, d),
            position["log_tau_s"], d.x, d.y, d.mask, rng=rng, frozen=frozen,
            const=_const(d),
        )
        return nb, {"v": nv, "g": ng, "h": nh}, alpha

    def gibbs_mu(rng, state, d):
        """Exact conjugate draw of mu | beta_g, tau_g per coordinate."""
        s1, _ = _suff_g(state)
        inv_tau2 = torch.exp(-2.0 * state["log_tau_g"])
        prec = G * inv_tau2 + inv_s0_2
        mean = s1 * inv_tau2 / prec
        return mean + rng.normal(mean.shape) / torch.sqrt(prec)

    def _gibbs_tau(rng, quad, n_units):
        """Exact conjugate draw (invgamma prior): tau^2 | . ~ InvGamma(a +
        n/2, b + quad/2) as rate / Gamma(shape), returned as log tau and
        clipped to [-12, 12] (the log_scale_guard support)."""
        rate = b_ig + 0.5 * quad
        g = rng.gamma(a_ig + 0.5 * n_units, quad.shape)
        return torch.clamp(
            0.5 * (torch.log(rate) - torch.log(g)), -12.0, 12.0
        )

    def gibbs_log_tau_g(rng, state, d):
        s1, s2 = _suff_g(state)
        mu = state["mu"]
        return _gibbs_tau(rng, s2 - 2.0 * mu * s1 + G * mu * mu, G)

    def gibbs_log_tau_s(rng, state, d):
        return _gibbs_tau(rng, _dev2_s(state, d), S)

    def gibbs_beta_g(rng, state, d):
        """Exact conjugate draw of beta_g | beta_s, mu, tau_s, tau_g: per
        (group, coordinate) N((S_g/tau_s^2 + mu/tau_g^2)/prec, 1/prec),
        prec = n_subjects(g)/tau_s^2 + 1/tau_g^2."""
        s_g = d.group_sum(state["beta_s"])                  # (C, G, p)
        inv_ts2 = torch.exp(-2.0 * state["log_tau_s"])[:, None, :]
        inv_tg2 = torch.exp(-2.0 * state["log_tau_g"])[:, None, :]
        prec = d.subject_counts[None, :, None] * inv_ts2 + inv_tg2
        mean = (s_g * inv_ts2 + state["mu"][:, None, :] * inv_tg2) / prec
        return mean + rng.normal(mean.shape) / torch.sqrt(prec)

    def _alpha(log_alpha):
        return torch.where(
            torch.isnan(log_alpha), torch.zeros_like(log_alpha),
            torch.exp(log_alpha.clamp_max(0.0)),
        )

    def asis_tau_g_move(rng, position, cache, scale, d):
        """Interweaving for (tau_g, beta_g): rescale beta_g about mu with
        z_g = (beta_g - mu)/tau_g fixed. beta_s is unchanged, so no data
        are touched: the target is the subject prior plus the tau_g prior
        and Jacobian. Always a Laplace proposal (``scale`` unused): per
        coordinate k, with d = beta_g'(s) - mu,
          F'_k = sum_s dev_sk d_sk / tau_s^2 + pr',
          M_k  = sum_s d_sk^2 / tau_s^2 - pr'',
        lt' = lt + F'/M + eps/sqrt(M), with the full asymmetric correction
        and the log-determinant ratio. Noise: eps (C, p), then log u (C,)."""
        bg, mu, lt = position["beta_g"], position["mu"], position["log_tau_g"]
        bs, lts = position["beta_s"], position["log_tau_s"]
        C = lt.shape[0]
        inv_ts2 = torch.exp(-2.0 * lts)[:, None, :]          # (C, 1, p)
        diff_g = bg - mu[:, None, :]                         # tau_g z

        def _quad_grad_metric(bg_eff, lt_at):
            """(sum_s -dev^2/2tau_s^2 (C,), F' (C, p), M (C, p)); the
            -S log tau_s terms are constant across the move."""
            bg_s = d.to_subjects(bg_eff)
            dev = bs - bg_s
            d_s = bg_s - mu[:, None, :]
            val = torch.sum(-0.5 * dev * dev * inv_ts2, dim=(1, 2))
            grad = (torch.sum(dev * inv_ts2 * d_s, dim=1)
                    + _tau_logprior_grad(lt_at))
            metric = (torch.sum(d_s * d_s * inv_ts2, dim=1)
                      + _tau_logprior_metric(lt_at))
            return val, grad, metric

        val_old, g_old, m_old = _quad_grad_metric(bg, lt)
        eps = rng.normal((C, p))
        lt_new = lt + g_old / m_old + eps / torch.sqrt(m_old)
        bg_new = mu[:, None, :] + diff_g * torch.exp(lt_new - lt)[:, None, :]
        val_new, g_new, m_new = _quad_grad_metric(bg_new, lt_new)
        rev = lt - (lt_new + g_new / m_new)
        q_corr = torch.sum(
            -0.5 * rev * rev * m_new + 0.5 * torch.log(m_new)
            + 0.5 * eps * eps - 0.5 * torch.log(m_old),
            dim=-1,
        )
        prior_delta = torch.sum(
            _tau_logprior(lt_new) + log_scale_guard(lt_new)
            - _tau_logprior(lt), dim=-1,
        )
        log_alpha = val_new - val_old + prior_delta + q_corr
        accept = rng.log_uniform((C,)) < log_alpha
        pos_up = {
            "beta_g": torch.where(accept[:, None, None], bg_new, bg),
            "log_tau_g": torch.where(accept[:, None], lt_new, lt),
        }
        return pos_up, {}, _alpha(log_alpha)

    def _asis_s_metric(h_packed, dd, lt_at):
        """Packed (C, T) Gauss-Newton metric of tau_s's z-fixed target:
        M_kl = sum_s h_s,kl d_sk d_sl + delta_kl (-pr''); dd (C, S, T)
        holds the products d_sk d_sl."""
        return ((h_packed * dd).sum(dim=1)
                + pack_diag(_tau_logprior_metric(lt_at), p))

    def asis_tau_s_move(rng, position, cache, scale, d, frozen=False):
        """Interweaving for (tau_s, beta_s): rescale beta_s about its
        group's beta_g with z_s fixed; one obs pass at the rescaled beta_s
        refreshes the carried cache. Its mode follows the cache:

        - {'v','g','h'} (Newton): a parameter-free Laplace proposal in the
          p-dim log tau_s with the Gauss-Newton metric from the carried
          packed Hessian; the eval pass computes the Hessian unless
          ``frozen`` (then the carried one is the constant metric).
        - {'v','g'} (MALA): Langevin with the drift from the carried
          likelihood gradient, s = ``scale`` (C, 1) adapted to 0.574.
        - a (C, S) loglik or None (RW): log tau_s' = log tau_s + s eps.

        Noise: eps (C, p), then log u (C,)."""
        bs, lt = position["beta_s"], position["log_tau_s"]
        C = lt.shape[0]
        bg_s = _bgs(position, d)
        diff = bs - bg_s                                     # tau_s z
        eps = rng.normal((C, p))
        lik_cache = cache.get("beta_s")
        grad_mode = isinstance(lik_cache, dict)
        newton_mode = grad_mode and "h" in lik_cache
        if newton_mode:
            f_old = ((lik_cache["g"] * diff).sum(dim=1)
                     + _tau_logprior_grad(lt))
            m_old = _asis_s_metric(lik_cache["h"],
                                   diff[..., ii] * diff[..., jj], lt)
            L_old = chol_packed(m_old, p)
            lt_new = (lt + spd_solve(L_old, f_old, p)
                      + solve_upper_t(L_old, eps, p))
        elif grad_mode:
            s2 = scale * scale                               # (C, 1)
            g_old = ((lik_cache["g"] * diff).sum(dim=1)
                     + _tau_logprior_grad(lt))
            lt_new = lt + 0.5 * s2 * g_old + scale * eps
        else:
            lt_new = lt + scale * eps
        ratio = torch.exp(lt_new - lt)[:, None, :]
        diff_new = diff * ratio
        bs_new = bg_s + diff_new
        if grad_mode:
            lik_old = lik_cache["v"]
            if newton_mode and not frozen:
                lik_new, grad_new, hess_new = lik_value_grad_hess(bs_new, d)
            else:
                lik_new, grad_new = lik_value_and_grad(bs_new, d)
                if newton_mode:
                    hess_new = lik_cache["h"]                # constant metric
            if newton_mode:
                f_new = ((grad_new * diff_new).sum(dim=1)
                         + _tau_logprior_grad(lt_new))
                m_new = _asis_s_metric(
                    hess_new, diff_new[..., ii] * diff_new[..., jj], lt_new)
                L_new = chol_packed(m_new, p)
                w_rev = lt_vec(L_new, lt - (lt_new + spd_solve(L_new, f_new,
                                                                p)), p)
                # the forward whitened residual is exactly eps
                q_corr = (
                    -0.5 * torch.sum(w_rev * w_rev, dim=-1)
                    + half_logdet(L_new, p)
                    + 0.5 * torch.sum(eps * eps, dim=-1)
                    - half_logdet(L_old, p)
                )
            else:
                g_new = ((grad_new * diff_new).sum(dim=1)
                         + _tau_logprior_grad(lt_new))
                fwd = lt_new - lt - 0.5 * s2 * g_old         # = scale eps
                rev = lt - lt_new - 0.5 * s2 * g_new
                q_corr = torch.sum(fwd * fwd - rev * rev, dim=-1) / (
                    2.0 * s2[:, 0]
                )
        else:
            lik_new = _lik(bs_new, d)
            lik_old = lik_cache
            if lik_old is None:
                lik_old = _lik(bs, d)
            q_corr = 0.0
        prior_delta = torch.sum(
            _tau_logprior(lt_new) + log_scale_guard(lt_new)
            - _tau_logprior(lt), dim=-1,
        )
        log_alpha = (torch.sum(lik_new - lik_old, dim=-1) + prior_delta
                     + q_corr)
        accept = rng.log_uniform((C,)) < log_alpha
        acc2 = accept[:, None]
        acc3 = accept[:, None, None]
        pos_up = {
            "beta_s": torch.where(acc3, bs_new, bs),
            "log_tau_s": torch.where(acc2, lt_new, lt),
        }
        cache_up = {}
        if grad_mode:
            cache_up["beta_s"] = {
                "v": torch.where(acc2, lik_new, lik_old),
                "g": torch.where(acc3, grad_new, lik_cache["g"]),
            }
            if newton_mode:
                cache_up["beta_s"]["h"] = (
                    lik_cache["h"] if frozen
                    else torch.where(acc3, hess_new, lik_cache["h"])
                )
        elif lik_cache is not None:
            cache_up["beta_s"] = torch.where(acc2, lik_new, lik_old)
        return pos_up, cache_up, _alpha(log_alpha)

    def joint(state, d):
        return (
            torch.sum(_lik(state["beta_s"], d), dim=-1)
            + torch.sum(_sprior(state, d), dim=-1)
            + torch.sum(_gprior(state), dim=-1)
            + _pprior(state)
        )

    def _tau_prior_sample(rng, chains):
        if conj_tau:
            return torch.sqrt(b_ig / rng.gamma(a_ig, (chains, p)))
        return prior_tau_scale * torch.abs(rng.normal((chains, p)))

    def prior_sample(rng, d, chains):
        """An exact draw from the prior of the chosen tau prior."""
        mu = prior_mu_scale * rng.normal((chains, p))
        tau_g = _tau_prior_sample(rng, chains)
        tau_s = _tau_prior_sample(rng, chains)
        beta_g = mu[:, None, :] + tau_g[:, None, :] * rng.normal(
            (chains, G, p))
        beta_s = d.to_subjects(beta_g) + tau_s[:, None, :] * rng.normal(
            (chains, S, p))
        return {
            "beta_s": beta_s, "beta_g": beta_g, "mu": mu,
            "log_tau_s": torch.log(tau_s), "log_tau_g": torch.log(tau_g),
        }

    def sample_data(rng, state, d):
        """Poisson counts given chain 0's beta_s, zero where masked."""
        eta = torch.einsum("snp,sp->sn", d.x, state["beta_s"][0])
        return dataclasses.replace(d, y=rng.poisson(torch.exp(eta)) * d.mask)

    def init_state(rng, d, chains):
        return {
            "beta_s": 0.2 * rng.normal((chains, S, p)),
            "beta_g": 0.2 * rng.normal((chains, G, p)),
            "mu": 0.2 * rng.normal((chains, p)),
            "log_tau_s": -1.0 + 0.2 * rng.normal((chains, p)),
            "log_tau_g": -1.0 + 0.2 * rng.normal((chains, p)),
        }

    return ModelSpec(
        name="nested_poisson",
        blocks=(
            Block("beta_s", (S, p), units=S, init_scale=0.2),
            Block("beta_g", (G, p), units=G, init_scale=0.2),
            Block("mu", (p,), units=p, init_scale=0.15),     # conjugate
            Block("log_tau_g", (p,), units=p, init_scale=0.2, repeats=4),
            Block("log_tau_s", (p,), units=p, init_scale=0.2, repeats=4),
        ),
        init_state=init_state,
        cond_logdensity=cond,
        joint_logdensity=joint,
        prior_sample=prior_sample,
        sample_data=sample_data,
        # the obs-level likelihood depends only on beta_s: carried across
        # sweeps so each sweep evaluates it once (for the proposal)
        cond_cached={
            "beta_s": (
                _lik,
                lambda v, state, d: _sprior({**state, "beta_s": v}, d),
            ),
        },
        cond_cached_grad={
            "beta_s": (lik_value_and_grad, sprior_value_and_grad),
        },
        cond_cached_newton={"beta_s": (lik_value_grad_hess, sprior_vgh)},
        fused_updates={"beta_s": fused_rwmh_beta_s_update},
        fused_updates_mala={"beta_s": fused_mala_beta_s_update},
        fused_updates_newton={"beta_s": fused_newton_beta_s_update},
        gibbs_draws={
            "mu": gibbs_mu,
            "beta_g": gibbs_beta_g,
            **({"log_tau_g": gibbs_log_tau_g, "log_tau_s": gibbs_log_tau_s}
               if conj_tau else {}),
        },
        joint_moves={
            "asis_tau_g": asis_tau_g_move,
            "asis_tau_s": asis_tau_s_move,
        },
        # tau_g's move touches no data, so it repeats cheaply; tau_s's
        # costs one obs pass a repeat
        joint_move_repeats={
            "asis_tau_g": max(1, int(asis_tau_g_repeats)),
            "asis_tau_s": max(1, int(asis_tau_s_repeats)),
        },
        # each move's log alpha sums S subject-prior terms (tau_g) or all
        # N = sum(mask) obs terms (tau_s): steps shrink like 1/sqrt(count)
        joint_move_init_scale={
            "asis_tau_g": 2.38 / math.sqrt(p * max(S, 1)),
            "asis_tau_s": 2.38 / math.sqrt(p * max(n_obs, 1)),
        },
        # tau_g's move is a parameter-free Laplace proposal (no adaptation);
        # tau_s's resolves by the cache (kernels/gibbs.joint_move_target)
        joint_move_target_accept={"asis_tau_g": None, "asis_tau_s": "auto"},
    )


def synth_poisson3(seed, G: int = 20, subjects_per_group: int = 5,
                   n: int = 10, p: int = 3, device="cuda"):
    """Synthetic three-level Poisson data from the reference's generative
    model, drawn with a numpy Generator seeded by ``seed``. Returns
    (NestedData3 on ``device``, the card unless the caller asks for
    another; truth dict of numpy arrays)."""
    r = np.random.default_rng(seed)
    S = G * subjects_per_group
    mu = 0.3 * r.standard_normal(p)
    tau_g = 0.2 + 0.1 * np.abs(r.standard_normal(p))
    tau_s = 0.2 + 0.1 * np.abs(r.standard_normal(p))
    beta_g = mu + tau_g * r.standard_normal((G, p))
    subject_group = np.repeat(np.arange(G), subjects_per_group)
    beta_s = beta_g[subject_group] + tau_s * r.standard_normal((S, p))
    x = (0.5 * r.standard_normal((S, n, p))).astype(np.float32)
    x[:, :, 0] = 1.0  # intercept column
    eta = np.einsum("snp,sp->sn", x, beta_s)
    y = r.poisson(np.exp(eta)).astype(np.float32)
    data = from_numpy3(x, y, np.ones((S, n), np.float32), subject_group, G,
                       device=device)
    truth = {"mu": mu, "tau_g": tau_g, "tau_s": tau_s, "beta_g": beta_g,
             "beta_s": beta_s}
    return data, truth
