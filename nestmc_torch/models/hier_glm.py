"""Generic two-level hierarchical GLM: the response families beyond the
named benchmark models.

    y_ij ~ family(eta_ij = x_ij . beta_j [, aux])
    beta_j ~ N(mu, diag(tau^2))
    mu_k ~ N(0, prior_mu_scale^2)                  exact conjugate draw
    tau_k ~ HalfNormal(prior_tau_scale)            MH on log tau
      or tau_k^2 ~ InvGamma(tau_ig_shape, tau_ig_scale)   exact draw

Port of :mod:`nestmc.models.hier_glm` on padded data
(:class:`~nestmc_torch.data.NestedData`). Families:

- 'gaussian': y ~ N(eta, sigma), sigma unknown: the scalar population
  block ``log_sigma`` enters the likelihood;
- 'negbin': y ~ NegBin(mean e^eta, concentration r), the block ``log_r``
  the same way (gamma-Poisson mixture);
- 'poisson': y ~ Poisson(e^eta);
- 'binomial': y successes of ``data.extra['trials']``, logit link;
- 'bernoulli': binomial with one trial.

The aux-free families (poisson, binomial, bernoulli) carry the likelihood
across sweeps (the self/rest split of ``cond_cached*``); gaussian and
negbin, whose likelihood reads the aux block, keep the self part zero and
evaluate the whole conditional in the rest part (Newton-MH at two obs
passes an update). Every family has the analytic Newton hooks, the
conjugate mu draw, the inverse-gamma tau draw, the (tau, beta)
interweaving move and the prior and data simulators.

``fused=True`` (the default) puts the kernels under the families that
have them: bernoulli is :func:`make_hier_logistic` renamed; binomial is
:func:`make_hier_logistic` on the reweighted data (y/m, mask m), exact
because the mask enters every logistic kernel as a multiplicative weight
(:func:`_make_logistic_delegate`); poisson runs the fused Poisson steps
(ops/cuda/poisson_accept) with the prior mean mu broadcast to the groups,
and its self passes run the Poisson obs kernels (ops/cuda/loglik_poisson).
On CPU tensors these run their plain versions. ``fused=False`` keeps the
plain op-by-op form for every family; gaussian and negbin always run it.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from nestmc_torch.data import NestedData, from_numpy, memo_by_data
from nestmc_torch.distributions import (
    log_scale_guard,
    logpdf_halfnormal,
    logpdf_normal,
)
from nestmc_torch.model import Block, ModelSpec
from nestmc_torch.models.hier_logistic import make_hier_logistic
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
from nestmc_torch.ops.loglik import (
    eta_padded,
    poisson_const,
    xt_sum,
    xxt_packed,
)
from nestmc_torch.ops.smallchol import pack_diag
from nestmc_torch.parallel.collectives import (
    groups_sum,
    local_data,
    local_units,
    unit_span,
)

_LOG_2PI = 1.8378770664093453
FAMILIES = ("gaussian", "binomial", "bernoulli", "poisson", "negbin")


def _log_binom(trials, y, mask):
    """Per-observation masked log binomial coefficient log C(m, y)."""
    return (
        torch.lgamma(trials + 1.0) - torch.lgamma(y + 1.0)
        - torch.lgamma(trials - y + 1.0)
    ) * mask


def make_hier_glm(
    data: NestedData,
    family: str = "gaussian",
    prior_mu_scale: float = 5.0,
    prior_tau_scale: float = 2.0,
    prior_sigma_scale: float = 2.0,
    tau_prior: str = "halfnormal",
    tau_ig_shape: float = 2.0,
    tau_ig_scale: float = 0.5,
    fused: bool = True,
) -> ModelSpec:
    """Same arguments as nestmc.models.hier_glm.make_hier_glm."""
    G = data.num_groups
    p = data.num_covariates
    T = p * (p + 1) // 2
    gaussian = family == "gaussian"
    negbin = family == "negbin"
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    if fused and family in ("bernoulli", "binomial") and isinstance(
            data, NestedData):
        return _make_logistic_delegate(
            data, family, prior_mu_scale, prior_tau_scale, tau_prior,
            tau_ig_shape, tau_ig_scale,
        )
    # the aux population block that enters the likelihood
    aux = "log_sigma" if gaussian else ("log_r" if negbin else None)
    aux_free = aux is None
    if tau_prior not in ("halfnormal", "invgamma"):
        raise ValueError(tau_prior)
    conj_tau = tau_prior == "invgamma"
    if family == "binomial" and "trials" not in data.extra:
        raise ValueError("binomial family needs data.extra['trials']")
    a_ig, b_ig = tau_ig_shape, tau_ig_scale
    lp_const = a_ig * math.log(b_ig) - math.lgamma(a_ig)
    inv_s0_2 = 1.0 / prior_mu_scale**2

    def _data_terms(d):
        """{'lgy1': lgamma(y + 1), 'trials', 'log_binom'} of ``d``, the
        parameter-free per-observation terms; computed once for the
        build-time data."""
        out = {"lgy1": torch.lgamma(d.y + 1.0)}
        if family == "binomial":
            out["trials"] = d.extra["trials"]
            out["log_binom"] = _log_binom(out["trials"], d.y, d.mask)
        elif family == "bernoulli":
            out["trials"] = torch.ones_like(d.y)
            out["log_binom"] = torch.zeros_like(d.y)
        return out

    _terms_of = memo_by_data(_data_terms, data)

    def _tau_logprior(lt):
        """log p(log tau) elementwise, with the Jacobian to log space."""
        if conj_tau:
            return (
                lp_const - 2.0 * (a_ig + 1.0) * lt
                - b_ig * torch.exp(-2.0 * lt) + math.log(2.0) + 2.0 * lt
            )
        return logpdf_halfnormal(torch.exp(lt), prior_tau_scale) + lt

    def _eta(beta, d):
        return eta_padded(beta, d.x)

    # ---- analytic likelihood derivatives: per-observation score resid =
    # dll/deta and curvature w = -d2ll/deta2 give grad = X^T resid and the
    # packed -Hessian sum_i w_i x_i x_i^T
    def _family_terms(eta, d, aux_val, need_w: bool):
        """(ll, resid[, w]) per observation, unmasked. aux_val: the (C,)
        aux block value (log_sigma / log_r), None for aux-free families."""
        tm = _terms_of(d)
        if gaussian:
            lsig = aux_val[:, None, None]
            inv_s2 = torch.exp(-2.0 * lsig)
            diff = d.y - eta
            ll = -0.5 * (diff * diff * inv_s2 + _LOG_2PI) - lsig
            resid = diff * inv_s2
            w = inv_s2.expand(eta.shape)           # constant curvature
        elif family == "poisson":
            rate = torch.exp(eta)
            ll = d.y * eta - rate - tm["lgy1"]
            resid = d.y - rate
            w = rate
        elif negbin:
            lr = aux_val[:, None, None]
            r = torch.exp(lr)
            lrm = torch.logaddexp(lr, eta)
            # s = mu/(r+mu), t = r/(r+mu) from the same logaddexp
            s = torch.exp(eta - lrm)
            t = torch.exp(lr - lrm)
            ll = (
                torch.lgamma(d.y + r) - torch.lgamma(r) - tm["lgy1"]
                + r * (lr - lrm) + d.y * (eta - lrm)
            )
            resid = t * d.y - r * s                # r (y - mu) / (r + mu)
            w = (d.y + r) * t * s                  # observed info, >= 0
        else:
            sig = torch.sigmoid(eta)
            trials = tm["trials"]
            ll = (d.y * eta - trials * torch.nn.functional.softplus(eta)
                  + tm["log_binom"])
            resid = d.y - trials * sig
            w = trials * sig * (1.0 - sig)
        if need_w:
            return ll, resid, w
        return ll, resid

    def _lik_value_grad(value, d, aux_val):
        ll, resid = _family_terms(_eta(value, d), d, aux_val, need_w=False)
        return (
            torch.sum(ll * d.mask, dim=-1),
            xt_sum(resid * d.mask, d.x),
        )

    def _lik_vgh(value, d, aux_val):
        ll, resid, w = _family_terms(_eta(value, d), d, aux_val, need_w=True)
        return (
            torch.sum(ll * d.mask, dim=-1),
            xt_sum(resid * d.mask, d.x),
            xxt_packed(d.x, w * d.mask),
        )

    def _gprior(state):
        """(C, G) Gaussian group prior of beta."""
        tau = torch.exp(state["log_tau"])[:, None, :]
        return torch.sum(
            logpdf_normal(state["beta"], state["mu"][:, None, :], tau),
            dim=-1,
        )

    def gprior_value_and_grad(value, state, d):
        mu = state["mu"][:, None, :]
        inv_tau2 = torch.exp(-2.0 * state["log_tau"])[:, None, :]
        diff = value - mu
        gp_val = torch.sum(
            -0.5 * diff * diff * inv_tau2 + 0.5 * torch.log(inv_tau2)
            - 0.9189385332046727,
            dim=-1,
        )
        return gp_val, -diff * inv_tau2

    def gprior_vgh(value, state, d):
        gp_val, gp_grad = gprior_value_and_grad(value, state, d)
        inv_tau2 = torch.exp(-2.0 * state["log_tau"])
        return gp_val, gp_grad, pack_diag(inv_tau2, p)[:, None, :]

    # the Poisson family on the kernels: its self passes are the Poisson obs
    # passes with the per-group constant sum_i mask lgamma(y + 1) computed
    # once for the build-time data
    pois_fused = fused and family == "poisson"
    _const = (memo_by_data(lambda d: poisson_const(d.y, d.mask), data)
              if pois_fused else None)

    if pois_fused:
        def lik_self_v(value, d):
            return poisson_loglik(value, d.x, d.y, d.mask, _const(d))

        def lik_self_vg(value, d):
            return poisson_logp_grad(value, d.x, d.y, d.mask, _const(d))

        def lik_self_vgh(value, d):
            return poisson_logp_grad_hess(value, d.x, d.y, d.mask, _const(d))
    else:
        def lik_self_v(value, d):
            ll, _ = _family_terms(_eta(value, d), d, None, need_w=False)
            return torch.sum(ll * d.mask, dim=-1)

        def lik_self_vg(value, d):
            return _lik_value_grad(value, d, None)

        def lik_self_vgh(value, d):
            return _lik_vgh(value, d, None)

    def _lik(state, d):
        """(C, G) data loglik at ``state``: the Poisson obs pass on the
        kernel route, else the plain form."""
        if pois_fused:
            return lik_self_v(state["beta"], d)
        ll, _ = _family_terms(_eta(state["beta"], d), d,
                              state[aux] if aux else None, need_w=False)
        return torch.sum(ll * d.mask, dim=-1)

    if aux_free:
        # the likelihood reads beta only: the cacheable split (self = data
        # loglik, rest = Gaussian group prior), as hier_logistic's
        _cond_cached = {
            "beta": (
                lik_self_v,
                lambda v, state, d: _gprior({**state, "beta": v}),
            ),
        }
        _cond_cached_grad = {"beta": (lik_self_vg, gprior_value_and_grad)}
        _cond_cached_newton = {"beta": (lik_self_vgh, gprior_vgh)}
    else:
        # gaussian / negbin: the likelihood reads the aux block, so a
        # carried self part would go stale whenever the aux block moves.
        # The self part stays zero and the rest part is the whole
        # conditional: exact Newton-MH at two obs passes an update, with
        # nothing for newton_freeze to freeze.
        def _zero_self_vgh(value, d):
            C, Gv = value.shape[0], value.shape[1]
            return (value.new_zeros((C, Gv)), torch.zeros_like(value),
                    value.new_zeros((C, Gv, T)))

        def _full_rest_vgh(value, state, d):
            lv, lg, lh = _lik_vgh(value, d, state[aux])
            pv, pg, ph = gprior_vgh(value, state, d)
            return lv + pv, lg + pg, lh + ph

        _cond_cached = {}
        _cond_cached_grad = {}
        _cond_cached_newton = {"beta": (_zero_self_vgh, _full_rest_vgh)}

    def _mu_bg(position):
        """mu as the per-group prior mean, a contiguous (C, G, p) operand
        of the Poisson steps (one copy a call)."""
        return position["mu"][:, None, :].expand(
            position["beta"].shape).contiguous()

    def fused_beta_update(rng, position, cache, log_scale, d):
        """One fused RW-MH update of beta (ops/cuda/poisson_accept)."""
        lik_cache = cache.get("beta")
        if lik_cache is None:
            lik_cache = lik_self_v(position["beta"], d)
        return fused_rwmh_poisson_step(
            position["beta"], lik_cache, log_scale, _mu_bg(position),
            position["log_tau"], d.x, d.y, d.mask, rng=rng, const=_const(d),
            units=unit_span("groups"),
        )

    def fused_mala_beta_update(rng, position, cache, log_scale, d):
        """One fused MALA update of beta (ops/cuda/poisson_accept)."""
        c = cache.get("beta")
        if isinstance(c, dict):
            v, g = c["v"], c["g"]
        else:
            v, g = lik_self_vg(position["beta"], d)
        nb, nv, ng, alpha = fused_mala_poisson_step(
            position["beta"], v, g, log_scale, _mu_bg(position),
            position["log_tau"], d.x, d.y, d.mask, rng=rng, const=_const(d),
            units=unit_span("groups"),
        )
        return nb, {"v": nv, "g": ng}, alpha

    def fused_newton_beta_update(rng, position, cache, log_scale, d,
                                 frozen=False):
        """One fused Newton-MH update of beta (ops/cuda/poisson_accept);
        frozen: the carried Hessian is a constant metric."""
        c = cache.get("beta")
        if isinstance(c, dict) and "h" in c:
            v, g, h = c["v"], c["g"], c["h"]
        else:
            v, g, h = lik_self_vgh(position["beta"], d)
        nb, nv, ng, nh, alpha = fused_newton_poisson_step(
            position["beta"], v, g, h, log_scale, _mu_bg(position),
            position["log_tau"], d.x, d.y, d.mask, rng=rng, frozen=frozen,
            const=_const(d), units=unit_span("groups"),
        )
        return nb, {"v": nv, "g": ng, "h": nh}, alpha

    def _suff(beta):
        return groups_sum(beta, 1), groups_sum(beta * beta, 1)

    def _gprior_perk(s1, s2, mu, log_tau):
        quad = s2 - 2.0 * mu * s1 + G * mu * mu
        return (
            -0.5 * quad * torch.exp(-2.0 * log_tau)
            - G * log_tau - 0.5 * G * _LOG_2PI
        )

    def cond(name, value, state, d):
        state = {**state, name: value}
        if name == "beta":
            return _lik(state, d) + _gprior(state)
        if name == aux:
            # the aux scale / dispersion block: the data likelihood plus a
            # half-normal prior on the natural scale with its Jacobian
            prior = (
                logpdf_halfnormal(torch.exp(value), prior_sigma_scale)
                + value + log_scale_guard(value)
            )
            return groups_sum(_lik(state, d), -1) + prior
        s1, s2 = _suff(state["beta"])
        if name == "mu":
            return _gprior_perk(
                s1, s2, state["mu"], state["log_tau"]
            ) + logpdf_normal(state["mu"], 0.0, prior_mu_scale)
        if name == "log_tau":
            lt = state["log_tau"]
            return (
                _gprior_perk(s1, s2, state["mu"], lt)
                + _tau_logprior(lt) + log_scale_guard(lt)
            )
        raise KeyError(name)

    def joint(state, d):
        out = (
            groups_sum(_lik(state, d), -1)
            + groups_sum(_gprior(state), -1)
            + torch.sum(logpdf_normal(state["mu"], 0.0, prior_mu_scale),
                        dim=-1)
            + torch.sum(_tau_logprior(state["log_tau"]), dim=-1)
        )
        if aux is not None:
            out = out + logpdf_halfnormal(
                torch.exp(state[aux]), prior_sigma_scale) + state[aux]
        return out

    def init_state(rng, d, chains):
        st = {
            "beta": 0.3 * rng.normal((chains, G, p)),
            "mu": 0.3 * rng.normal((chains, p)),
            "log_tau": -0.5 + 0.3 * rng.normal((chains, p)),
        }
        if aux is not None:
            st[aux] = 0.2 * rng.normal((chains,))
        return st

    def prior_sample(rng, d, chains):
        """An exact draw from the prior of the chosen tau prior."""
        mu = prior_mu_scale * rng.normal((chains, p))
        if conj_tau:
            tau = torch.sqrt(b_ig / rng.gamma(a_ig, (chains, p)))
        else:
            tau = prior_tau_scale * torch.abs(rng.normal((chains, p)))
        beta = mu[:, None, :] + tau[:, None, :] * rng.normal((chains, G, p))
        st = {"beta": beta, "mu": mu, "log_tau": torch.log(tau)}
        if aux is not None:
            st[aux] = torch.log(
                prior_sigma_scale * torch.abs(rng.normal((chains,))))
        return st

    def sample_data(rng, state, d):
        """Responses of the family given chain 0's parameters, zero where
        masked."""
        eta = torch.einsum("gnp,gp->gn", d.x, state["beta"][0])
        if gaussian:
            y = eta + torch.exp(state["log_sigma"][0]) * rng.normal(eta.shape)
        elif family == "poisson":
            y = rng.poisson(torch.exp(eta))
        elif negbin:
            r = torch.exp(state["log_r"][0])
            y = rng.poisson(torch.exp(eta) / r * rng.gamma(r, eta.shape))
        else:
            trials = (d.extra["trials"] if family == "binomial"
                      else torch.ones_like(d.y))
            y = rng.binomial(trials, torch.sigmoid(eta))
        return dataclasses.replace(d, y=y * d.mask)

    def gibbs_mu(rng, state, d):
        """Exact conjugate draw of mu | beta, tau per coordinate."""
        s1, _ = _suff(state["beta"])
        inv_tau2 = torch.exp(-2.0 * state["log_tau"])
        prec = G * inv_tau2 + inv_s0_2
        mean = s1 * inv_tau2 / prec
        return mean + rng.normal(mean.shape) / torch.sqrt(prec)

    def gibbs_log_tau(rng, state, d):
        """Exact conjugate draw (invgamma prior): tau_k^2 | beta, mu ~
        InvGamma(a + G/2, b + quad_k/2), as log tau clipped to [-12, 12]."""
        s1, s2 = _suff(state["beta"])
        mu = state["mu"]
        quad = s2 - 2.0 * mu * s1 + G * mu * mu
        rate = b_ig + 0.5 * quad
        g = rng.gamma(a_ig + 0.5 * G, quad.shape)
        return torch.clamp(
            0.5 * (torch.log(rate) - torch.log(g)), -12.0, 12.0)

    def asis_tau_move(rng, position, cache, scale, d, frozen=False):
        """RW interweaving move on (tau, beta) with z = (beta - mu)/tau
        fixed: log tau' = log tau + s eps, beta' = mu + (tau'/tau)(beta -
        mu). A carried beta cache (aux-free families) is refreshed through
        the self hook of the cache kind it holds, so an accepted move never
        leaves it stale; frozen: the carried Hessian is a constant metric,
        the refresh takes value and gradient and h passes through. Noise:
        eps (C, p), then log u (C,)."""
        beta, mu, lt = position["beta"], position["mu"], position["log_tau"]
        C = lt.shape[0]
        lt_new = lt + scale * rng.normal(lt.shape)
        ratio = torch.exp(lt_new - lt)[:, None, :]
        beta_new = mu[:, None, :] + (beta - mu[:, None, :]) * ratio
        beta_cache = cache.get("beta")
        newton_cache = isinstance(beta_cache, dict) and "h" in beta_cache
        grad_cache = isinstance(beta_cache, dict) and not newton_cache
        if newton_cache:
            lik_old_pg = beta_cache["v"]
            if frozen:
                if aux_free:
                    v_new, g_new = lik_self_vg(beta_new, d)
                else:
                    v_new = torch.zeros_like(beta_cache["v"])
                    g_new = torch.zeros_like(beta_cache["g"])
                h_new = beta_cache["h"]
            else:
                v_new, g_new, h_new = _cond_cached_newton["beta"][0](
                    beta_new, d)
            lik_new_pg = v_new
            if not aux_free:
                # the zero-self split: per-group logliks of the full model
                lik_old_pg = _lik(position, d)
                lik_new_pg = _lik({**position, "beta": beta_new}, d)
        elif grad_cache:
            lik_old_pg = beta_cache["v"]
            lik_new_pg, g_new = lik_self_vg(beta_new, d)
        elif beta_cache is not None:
            lik_old_pg = beta_cache
            lik_new_pg = lik_self_v(beta_new, d)
        else:
            lik_old_pg = _lik(position, d)
            lik_new_pg = _lik({**position, "beta": beta_new}, d)
        prior_delta = torch.sum(
            _tau_logprior(lt_new) + log_scale_guard(lt_new)
            - _tau_logprior(lt), dim=-1,
        )
        log_alpha = (groups_sum(lik_new_pg, -1)
                     - groups_sum(lik_old_pg, -1) + prior_delta)
        accept = rng.log_uniform((C,)) < log_alpha
        acc2 = accept[:, None]
        acc3 = accept[:, None, None]
        pos_up = {
            "beta": torch.where(acc3, beta_new, beta),
            "log_tau": torch.where(acc2, lt_new, lt),
        }
        cache_up = {}
        if newton_cache:
            cache_up["beta"] = {
                "v": torch.where(acc2, v_new, beta_cache["v"]),
                "g": torch.where(acc3, g_new, beta_cache["g"]),
                "h": beta_cache["h"] if frozen
                else torch.where(acc3, h_new, beta_cache["h"]),
            }
        elif grad_cache:
            cache_up["beta"] = {
                "v": torch.where(acc2, lik_new_pg, beta_cache["v"]),
                "g": torch.where(acc3, g_new, beta_cache["g"]),
            }
        elif beta_cache is not None:
            cache_up["beta"] = torch.where(acc2, lik_new_pg, beta_cache)
        alpha = torch.where(
            torch.isnan(log_alpha), torch.zeros_like(log_alpha),
            torch.exp(log_alpha.clamp_max(0.0)),
        )
        return pos_up, cache_up, alpha

    blocks = [
        Block("beta", (G, p), units=G, init_scale=0.3),
        Block("mu", (p,), units=p, init_scale=0.2),
        Block("log_tau", (p,), units=p, init_scale=0.2, repeats=4),
    ]
    if aux is not None:
        # scalar noise / dispersion: a population block that reads the data
        blocks.append(Block(aux, (), init_scale=0.1, repeats=2))

    return ModelSpec(
        name=f"hier_glm_{family}",
        blocks=tuple(blocks),
        init_state=init_state,
        cond_logdensity=cond,
        joint_logdensity=joint,
        prior_sample=prior_sample,
        sample_data=sample_data,
        cond_cached=_cond_cached,
        cond_cached_grad=_cond_cached_grad,
        cond_cached_newton=_cond_cached_newton,
        fused_updates={"beta": fused_beta_update} if pois_fused else {},
        fused_updates_mala=(
            {"beta": fused_mala_beta_update} if pois_fused else {}),
        fused_updates_newton=(
            {"beta": fused_newton_beta_update} if pois_fused else {}),
        gibbs_draws={
            "mu": gibbs_mu,
            **({"log_tau": gibbs_log_tau} if conj_tau else {}),
        },
        joint_moves={"asis_tau": asis_tau_move},
        # log alpha sums likelihood deltas over all G groups: start at the
        # (p G)^(-1/2) law
        joint_move_init_scale={
            "asis_tau": 2.38 / math.sqrt(p * max(G, 1)),
        },
        # per-group loglik (C, G) for WAIC / PSIS-LOO on the build-time
        # data, one obs pass a retained draw when collected
        derived={"group_loglik": lambda pos: _lik(pos, local_data(data))},
        # group sharding splits beta and group_loglik on the group axis
        unit_axes={"beta": "groups", "group_loglik": "groups"},
    )


def _reweighted(d: NestedData) -> NestedData:
    """Binomial data as weighted Bernoulli-logit data: y -> y/m, mask ->
    mask m (trials m = d.extra['trials']); sizes are kept."""
    m = d.extra["trials"]
    return NestedData(
        y=torch.where(m > 0, d.y / m.clamp_min(1.0), torch.zeros_like(d.y)),
        mask=d.mask * m, sizes=d.sizes, x=d.x, extra={},
    )


def _make_logistic_delegate(data, family, prior_mu_scale, prior_tau_scale,
                            tau_prior, tau_ig_shape, tau_ig_scale):
    """bernoulli and binomial on the hierarchical logistic model, so they
    run its kernels (fused RW-MH, MALA and Newton steps, the obs passes,
    the carried caches and interweaves).

    bernoulli is the same model, renamed. binomial reduces exactly to the
    weighted logistic likelihood, since the mask enters every term as a
    multiplicative weight (csrc/logistic_terms.cuh):

        ll    = sum_i m_i [(y_i/m_i) eta - softplus(eta)] + log C(m, y)
        score = m (y/m - sigmoid) = y - m sigmoid
        curv  = m sigmoid (1 - sigmoid)

    so (y, mask) -> (y/m, mask m) gives the binomial loglik, gradient and
    Hessian up to the theta-free log binomial coefficient, which the
    derived group_loglik adds back (WAIC and PSIS-LOO on the pmf scale).
    Every hook that takes data transforms it; the build-time data's
    transform is computed once and reused whenever a hook receives that
    same object, so the sampler's hooks add no launch for it."""
    binom = family == "binomial"
    if binom and "trials" not in data.extra:
        raise ValueError("binomial family needs data.extra['trials']")
    _t = memo_by_data(lambda d: _reweighted(d), data) if binom else None
    t_data = _t(data) if binom else data
    base = make_hier_logistic(
        t_data,
        prior_mu_scale=prior_mu_scale,
        prior_tau_scale=prior_tau_scale,
        tau_prior=tau_prior,
        tau_ig_shape=tau_ig_shape,
        tau_ig_scale=tau_ig_scale,
    )
    if not binom:
        return dataclasses.replace(base, name="hier_glm_bernoulli")

    # the theta-free log binomial coefficient a group, (G,)
    log_binom = torch.sum(
        _log_binom(data.extra["trials"], data.y, data.mask), dim=-1)

    def wrap(fn, idx):
        """``fn`` with _t applied to its data argument at position
        ``idx``; its signature is kept (functools.wraps), so the sweep still
        sees a fused hook's ``rhat_fold`` and ``frozen``."""
        if fn is None:
            return None

        @functools.wraps(fn)
        def g(*args, **kw):
            a = list(args)
            a[idx] = _t(a[idx])
            return fn(*a, **kw)

        return g

    def wrapd(dct, idxs):
        """A dict of hooks (or tuples of hooks) with the data argument's
        position of each slot."""
        out = {}
        for k, v in dct.items():
            if isinstance(v, tuple):
                out[k] = tuple(wrap(f, i) for f, i in zip(v, idxs))
            else:
                out[k] = wrap(v, idxs[0])
        return out

    def sample_data(rng, state, d):
        """Binomial responses given chain 0's beta, in count space (the
        hooks transform whatever data they receive)."""
        eta = torch.einsum("gnp,gp->gn", d.x, state["beta"][0])
        y = rng.binomial(d.extra["trials"], torch.sigmoid(eta))
        return dataclasses.replace(d, y=y * d.mask.clamp_max(1.0))

    lik_fn = base.cond_cached["beta"][0]
    return dataclasses.replace(
        base,
        name="hier_glm_binomial",
        cond_logdensity=wrap(base.cond_logdensity, 3),
        joint_logdensity=wrap(base.joint_logdensity, 1),
        init_state=wrap(base.init_state, 1),
        prior_sample=wrap(base.prior_sample, 1),
        sample_data=sample_data,
        cond_value_and_grad=wrap(base.cond_value_and_grad, 3),
        cond_cached=wrapd(base.cond_cached, (1, 2)),
        cond_cached_grad=wrapd(base.cond_cached_grad, (1, 2)),
        cond_cached_newton=wrapd(base.cond_cached_newton, (1, 2)),
        gibbs_draws=wrapd(base.gibbs_draws, (2,)),
        joint_moves=wrapd(base.joint_moves, (4,)),
        fused_updates=wrapd(base.fused_updates, (4,)),
        fused_updates_mala=wrapd(base.fused_updates_mala, (4,)),
        fused_updates_newton=wrapd(base.fused_updates_newton, (4,)),
        derived={
            **base.derived,
            # the binomial pmf scale for WAIC / PSIS-LOO
            "group_loglik": lambda pos: (
                lik_fn(pos["beta"], _t(local_data(data)))
                + local_units(log_binom, 0)[None, :]),
        },
    )


def synth_glm(seed, family: str = "gaussian", G: int = 50, n: int = 20,
              p: int = 3, sigma: float = 0.7, trials: int = 10,
              r: float = 5.0, device="cuda"):
    """Synthetic data of one family from the reference's generative model,
    drawn with a numpy Generator seeded by ``seed``. Returns (NestedData on
    ``device``, the card unless the caller asks for another, with
    extra['trials'] for binomial; truth dict)."""
    if family not in FAMILIES:
        raise ValueError(family)
    gen = np.random.default_rng(seed)
    mu = 0.4 * gen.standard_normal(p)
    tau = 0.25 + 0.2 * np.abs(gen.standard_normal(p))
    beta = mu + tau * gen.standard_normal((G, p))
    x = gen.standard_normal((G, n, p)).astype(np.float32)
    x[:, :, 0] = 1.0  # intercept column
    eta = np.einsum("gnp,gp->gn", x, beta)
    extra = {}
    if family == "gaussian":
        y = eta + sigma * gen.standard_normal((G, n))
    elif family == "binomial":
        y = gen.binomial(trials, 1.0 / (1.0 + np.exp(-eta)))
        extra["trials"] = np.full((G, n), float(trials), np.float32)
    elif family == "bernoulli":
        y = gen.random((G, n)) < 1.0 / (1.0 + np.exp(-eta))
    elif family == "poisson":
        y = gen.poisson(np.exp(eta))
    else:
        # gamma-Poisson mixture: lam ~ Gamma(r, scale mu/r), y ~ Pois(lam)
        y = gen.poisson(np.exp(eta) / r * gen.gamma(r, size=(G, n)))
    data = from_numpy(x, np.asarray(y, np.float32),
                      np.ones((G, n), np.float32), device=device,
                      extra=extra)
    truth = {"mu": mu, "tau": tau, "beta": beta, "sigma": sigma, "r": r}
    return data, truth
