"""Hierarchical logistic regression — the judged benchmark model.

    y_ij ~ Bernoulli(sigmoid(x_ij . beta_j))     i obs in group j
    beta_j ~ N(mu, diag(tau^2))                  group-level coefficients
    mu_k ~ N(0, prior_mu_scale^2)
    tau_k ~ HalfNormal(prior_tau_scale)          sampled as log tau + Jacobian
      or tau_k^2 ~ InvGamma(tau_ig_shape, tau_ig_scale)

Port of :mod:`nestmc.models.hier_logistic` on padded and on ragged data:
both tau priors (half-normal: an MH block on log tau; inverse-gamma: an
exact conjugate draw), the exact conjugate mu draw, the fused RW-MH, MALA
and Newton-MH group-block updates (ops/cuda/mh_accept, mala_accept,
newton_accept) and the joint (mu, log tau) interweaving move in its three
modes (random walk, bound-metric Langevin, Laplace), and the joint density
with the prior and data simulators of the calibration tiers. The obs
passes run the CUDA kernels on CUDA tensors and their plain versions on
CPU tensors.

Ragged data (:class:`~nestmc_torch.data.RaggedData`) take one of two
routes, chosen by ``loglik_impl`` as in the reference's _resolve_loglik:
'bucket' (the default, 'auto') runs the padded kernels once per size
bucket (ops/bucket.py), with the fused MALA and Newton steps when every
group has an observation; 'pallas-segment' runs the segment kernels
(ops/cuda/loglik_segment) for the loglik and its gradient, the plain
segment Hessian, and the unfused updates.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from nestmc_torch.data import (
    NestedData,
    RaggedData,
    from_numpy,
    from_numpy_ragged,
)
from nestmc_torch.diagnostics import fold_rhat_update
from nestmc_torch.distributions import (
    log_scale_guard,
    logpdf_halfnormal,
    logpdf_normal,
)
from nestmc_torch.model import Block, ModelSpec
from nestmc_torch.ops import bucket as _bucket
from nestmc_torch.ops import loglik as _plain
from nestmc_torch.ops.cuda.loglik_logistic import (
    logistic_logp_grad,
    logistic_logp_grad_hess,
    logistic_loglik,
)
from nestmc_torch.ops.cuda.loglik_segment import (
    logistic_logp_grad_segment,
    logistic_loglik_segment,
)
from nestmc_torch.ops.cuda.mala_accept import fused_mala_logistic_step
from nestmc_torch.ops.cuda.mh_accept import fused_rwmh_logistic_step
from nestmc_torch.ops.cuda.newton_accept import fused_newton_logistic_step
from nestmc_torch.ops.segment import SegmentLayout
from nestmc_torch.ops.smallchol import (
    chol_packed,
    half_logdet,
    lt_vec,
    pack_diag,
    packed_index,
    solve_upper_t,
    spd_solve,
)

_LOG_2PI = math.log(2.0 * math.pi)


def _resolve_loglik(data, impl: str):
    """The (beta, data) -> (C, G) obs passes of one route: returns
    (lik, lik_grad, lik_grad_hess, chosen name, layout or None). Padded
    data take the padded kernels ('auto', chosen 'pallas' as in the
    reference); ragged data 'bucket' ('auto' too, the reference's choice
    on the accelerator) or 'pallas-segment'.
    Layouts are built here, once, from the concrete segment structure."""
    if not isinstance(data, RaggedData):
        if impl != "auto":
            raise ValueError(
                f"loglik_impl={impl!r}: padded data take 'auto'")

        def lik(v, d):
            return logistic_loglik(v, d.x, d.y, d.mask)

        def lik_grad(v, d):
            return logistic_logp_grad(v, d.x, d.y, d.mask)

        def lik_grad_hess(v, d):
            return logistic_logp_grad_hess(v, d.x, d.y, d.mask)
        return lik, lik_grad, lik_grad_hess, "pallas", None
    if impl in ("auto", "bucket"):
        layout = _bucket.BucketLayout.build(
            data.segment_ids, data.num_groups, x=data.x, y=data.y
        )
        return (
            lambda v, d: _bucket.bucketed_logistic_loglik(v, layout),
            lambda v, d: _bucket.bucketed_logistic_logp_grad(v, layout),
            lambda v, d: _bucket.bucketed_logistic_logp_grad_hess(v, layout),
            "bucket", layout,
        )
    if impl == "pallas-segment":
        layout = SegmentLayout.build(data.segment_ids, data.num_groups)

        def lik_grad_hess(v, d):
            # the reference has no kernel for the ragged Hessian pass: its
            # jnp form, here the plain one, serves this route
            return _plain.logistic_logp_grad_hess_segment(
                v, d.x, d.y, layout.segment_ids, layout.num_groups)
        return (
            lambda v, d: logistic_loglik_segment(v, d.x, d.y, layout),
            lambda v, d: logistic_logp_grad_segment(v, d.x, d.y, layout),
            lik_grad_hess, "pallas-segment", layout,
        )
    raise ValueError(
        f"loglik_impl={impl!r}: ragged data take 'auto', 'bucket' or "
        "'pallas-segment'")


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
    """Same arguments as nestmc.models.make_hier_logistic. ``data`` is
    NestedData (loglik_impl 'auto') or RaggedData ('auto' = 'bucket', or
    'pallas-segment')."""
    if tau_prior not in ("halfnormal", "invgamma"):
        raise ValueError(tau_prior)
    conj_tau = tau_prior == "invgamma"
    lik_fn, lik_value_and_grad, lik_value_grad_hess, chosen, layout = (
        _resolve_loglik(data, loglik_impl)
    )
    ragged = isinstance(data, RaggedData)
    # the bucketed fused steps skip size-0 groups, which still need their
    # prior-only move: offered only when every group has an observation
    bucket_full = chosen == "bucket" and _bucket.covers_all_groups(layout)
    G = data.num_groups
    p = data.num_covariates
    q = 2 * p                                       # joint (mu, lt) dim
    a_ig, b_ig = tau_ig_shape, tau_ig_scale
    lp_const = a_ig * math.log(b_ig) - math.lgamma(a_ig)
    inv_s0_2 = 1.0 / prior_mu_scale**2
    inv_S2 = 1.0 / prior_tau_scale**2
    dev = data.device
    hidx = torch.tensor(
        [[packed_index(i, j) for j in range(p)] for i in range(p)],
        device=dev,
    )
    qidx = torch.tensor(
        [i * q + j for i in range(q) for j in range(i + 1)], device=dev
    )
    eye_p = torch.eye(p, device=dev)

    # Data-constant packed Hessian BOUND 0.25 sum_i x x^T per group (the
    # logistic curvature w = s(1 - s) <= 1/4): the metric of the joint
    # interweaving move in grad (MALA) mode, built once from the data.
    xn = data.x.double().cpu().numpy()
    if ragged:
        seg = data.segment_ids.cpu().numpy()
        cols = []
        for i in range(p):
            for j in range(i + 1):
                col = np.zeros(G)
                np.add.at(col, seg, 0.25 * xn[:, i] * xn[:, j])
                cols.append(col)
    else:
        mn = data.mask.double().cpu().numpy()
        cols = [0.25 * np.sum(mn * xn[:, :, i] * xn[:, :, j], axis=1)
                for i in range(p) for j in range(i + 1)]
    xxt_bound = torch.tensor(np.stack(cols, axis=-1), dtype=torch.float32,
                             device=dev)[None]              # (1, G, T)

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

    _suff_of = {}

    def _suff(beta):
        """(s1, s2) = (sum_g beta, sum_g beta^2), each (C, p). The
        population blocks read beta only through them, and beta does not
        change between the mu draw and the log_tau repeats of a sweep, so
        they are computed once per value of beta (the reference gets the
        same from XLA's common-subexpression elimination in its traced
        sweep) instead of re-reading the (C, G, p) block per evaluation."""
        ref = _suff_of.get("beta")
        if ref is None or ref() is not beta:
            _suff_of["beta"] = weakref.ref(beta)
            _suff_of["s"] = (beta.sum(dim=1), (beta * beta).sum(dim=1))
        return _suff_of["s"]

    def _quad(s1, s2, mu):
        return s2 - 2.0 * mu * s1 + G * mu * mu     # (C, p)

    def _gprior_perk_from_suff(s1, s2, mu, log_tau):
        """sum_g log N(beta_gk | mu_k, tau_k) per coordinate k, (C, p)."""
        tau2 = torch.exp(2.0 * log_tau)
        return (
            -0.5 * _quad(s1, s2, mu) / tau2 - G * log_tau - 0.5 * G * _LOG_2PI
        )

    def _gprior(state):
        """(C, G) Gaussian group prior of beta."""
        tau = torch.exp(state["log_tau"])[:, None, :]
        return torch.sum(
            logpdf_normal(state["beta"], state["mu"][:, None, :], tau),
            dim=-1,
        )

    def cond(name, value, state, data):
        state = {**state, name: value}
        if name == "beta":
            return lik_fn(state["beta"], data) + _gprior(state)
        s1, s2 = _suff(state["beta"])
        if name == "mu":
            return _gprior_perk_from_suff(
                s1, s2, state["mu"], state["log_tau"]
            ) + logpdf_normal(state["mu"], 0.0, prior_mu_scale)
        if name == "log_tau":
            lt = state["log_tau"]
            return (
                _gprior_perk_from_suff(s1, s2, state["mu"], lt)
                + _tau_logprior(lt) + log_scale_guard(lt)
            )
        raise KeyError(name)

    def gprior_value_and_grad(value, state, data):
        """Closed-form per-group Gaussian prior value (C, G) and gradient."""
        mu = state["mu"][:, None, :]
        inv_tau2 = torch.exp(-2.0 * state["log_tau"])[:, None, :]
        diff = value - mu
        gp_val = torch.sum(
            -0.5 * diff * diff * inv_tau2 + 0.5 * torch.log(inv_tau2)
            - 0.9189385332046727,
            dim=-1,
        )
        return gp_val, -diff * inv_tau2

    def gprior_vgh(value, state, data):
        """The Gaussian prior's value, gradient and packed constant
        precision diag(1/tau^2) as (C, 1, T)."""
        gp_val, gp_grad = gprior_value_and_grad(value, state, data)
        inv_tau2 = torch.exp(-2.0 * state["log_tau"])
        return gp_val, gp_grad, pack_diag(inv_tau2, p)[:, None, :]

    def cond_value_and_grad(name, value, state, data):
        """Closed-form value and gradient of the beta and log_tau
        conditionals (the log_tau one from the sufficient statistics; the
        guard's gradient is 0); None for other blocks."""
        if name == "beta":
            ll, gll = lik_value_and_grad(value, data)
            gp_val, gp_grad = gprior_value_and_grad(value, state, data)
            return ll + gp_val, gll + gp_grad
        if name == "log_tau":
            s1, s2 = _suff(state["beta"])
            quad_tau2 = _quad(s1, s2, state["mu"]) / torch.exp(2.0 * value)
            val = (
                -0.5 * quad_tau2 - G * value - 0.5 * G * _LOG_2PI
                + _tau_logprior(value) + log_scale_guard(value)
            )
            return val, quad_tau2 - G + _tau_logprior_grad(value)
        return None

    def fused_beta_update(rng, position, cache, log_scale, data):
        """One fused RW-MH update of beta (ops/cuda/mh_accept)."""
        lik_cache = cache.get("beta")
        if lik_cache is None:
            lik_cache = lik_fn(position["beta"], data)
        return fused_rwmh_logistic_step(
            position["beta"], lik_cache, log_scale,
            position["mu"], position["log_tau"], data.x, data.y, data.mask,
            rng=rng,
        )

    def _plain_fold(rhat_fold, beta):
        return fold_rhat_update(rhat_fold[0], rhat_fold[1],
                                beta.permute(1, 2, 0), rhat_fold[2])

    def fused_mala_beta_update(rng, position, cache, log_scale, data,
                               rhat_fold=None):
        """One fused MALA update of beta (ops/cuda/mala_accept; on ragged
        data once per size bucket, ops/bucket.py); with rhat_fold, the
        pre-update beta is folded (in the same pass on padded data, by the
        plain fold on ragged data, as the reference does) and the new
        (mean, m2) are appended to the return."""
        c = cache.get("beta")
        if isinstance(c, dict):
            v, g = c["v"], c["g"]
        else:
            v, g = lik_value_and_grad(position["beta"], data)
        if ragged:
            nb, nv, ng, alpha = _bucket.bucketed_fused_mala_step(
                position["beta"], v, g, log_scale, position["mu"],
                position["log_tau"], layout, rng=rng,
            )
            if rhat_fold is not None:
                return nb, {"v": nv, "g": ng}, alpha, _plain_fold(
                    rhat_fold, position["beta"])
            return nb, {"v": nv, "g": ng}, alpha
        out = fused_mala_logistic_step(
            position["beta"], v, g, log_scale,
            position["mu"], position["log_tau"], data.x, data.y, data.mask,
            rng=rng, rhat_fold=rhat_fold,
        )
        nb, nv, ng, alpha = out[:4]
        if rhat_fold is not None:
            return nb, {"v": nv, "g": ng}, alpha, (out[4], out[5])
        return nb, {"v": nv, "g": ng}, alpha

    def fused_newton_beta_update(rng, position, cache, log_scale, data,
                                 frozen=False, rhat_fold=None):
        """One fused Newton-MH update of beta (ops/cuda/newton_accept; on
        ragged data once per size bucket, with the plain fold)."""
        c = cache.get("beta")
        if isinstance(c, dict) and "h" in c:
            v, g, h = c["v"], c["g"], c["h"]
        else:
            v, g, h = lik_value_grad_hess(position["beta"], data)
        if ragged:
            nb, nv, ng, nh, alpha = _bucket.bucketed_fused_newton_step(
                position["beta"], v, g, h, log_scale, position["mu"],
                position["log_tau"], layout, rng=rng, frozen=frozen,
            )
            new_cache = {"v": nv, "g": ng, "h": nh}
            if rhat_fold is not None:
                return nb, new_cache, alpha, _plain_fold(
                    rhat_fold, position["beta"])
            return nb, new_cache, alpha
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
        plus the prior precision (nestmc: _asis_joint_metric). h_packed is
        (C, G, T), or (1, G, T) for the data-constant bound."""
        C = d.shape[0]
        H = h_packed[..., hidx]                          # (C|1, G, p, p)
        dk = d[..., :, None]
        m_mm = (H.sum(dim=1) + inv_s0_2 * eye_p).expand(C, p, p)
        m_lm = (H * dk).sum(dim=1)                       # [lt_k, mu_l]
        m_ll = (H * dk * d[..., None, :]).sum(dim=1) + torch.diag_embed(
            _tau_logprior_metric(lt_at)
        )
        M = torch.cat([
            torch.cat([m_mm, m_lm.transpose(-1, -2)], dim=-1),
            torch.cat([m_lm, m_ll], dim=-1),
        ], dim=-2)
        return M.reshape(C, q * q)[:, qidx]

    def asis_tau_move(rng, position, cache, scale, data, frozen=False):
        """Interweaving move (Yu & Meng 2011) on the z-fixed target, z =
        (beta - mu)/tau held so beta' = mu' + (tau'/tau)(beta - mu). Its
        mode follows what the beta cache carries:

        - {'v','g','h'} (Newton): a parameter-free Laplace proposal
          N(theta + M^-1 F', M^-1) on theta = (mu, log tau), M the
          Gauss-Newton metric from the carried Hessian; ``scale`` unused.
          The eval pass computes the Hessian unless ``frozen``.
        - {'v','g'} (MALA): preconditioned Langevin theta + (s^2/2) Mb^-1 F'
          + s Mb^-1/2 eps with the data-constant bound metric Mb
          (xxt_bound), s = ``scale`` (C, 1) adapted to 0.574.
        - a (C, G) loglik or None (RW): log tau' = log tau + s eps, mu
          kept, s adapted to 0.234.

        Noise: the grad modes draw eps (C, 2p), the RW mode eps (C, p),
        then every mode draws log u (C,).
        """
        beta, mu, lt = position["beta"], position["mu"], position["log_tau"]
        C = lt.shape[0]
        diff = beta - mu[:, None, :]                     # tau z, (C, G, p)
        lik_cache = cache.get("beta")
        grad_mode = isinstance(lik_cache, dict)
        newton_mode = grad_mode and "h" in lik_cache
        if grad_mode:
            eps_q = rng.normal((C, q))
            h_src = lik_cache["h"] if newton_mode else xxt_bound
            if newton_mode:
                s, drift = 1.0, 1.0
            else:
                s = scale                                # (C, 1) adapted
                drift = 0.5 * s * s
            f_old = _asis_joint_grad(lik_cache["g"], diff, mu, lt)
            L_old = chol_packed(_asis_joint_metric(h_src, diff, lt), q)
            th_old = torch.cat([mu, lt], dim=-1)
            mean_old = th_old + drift * spd_solve(L_old, f_old, q)
            th_new = mean_old + s * solve_upper_t(L_old, eps_q, q)
            mu_new, lt_new = th_new[:, :p], th_new[:, p:]
        else:
            eps = rng.normal((C, p))
            mu_new, lt_new = mu, lt + scale * eps
        ratio = torch.exp(lt_new - lt)[:, None, :]
        diff_new = diff * ratio                          # e^{lt'} z
        beta_new = mu_new[:, None, :] + diff_new
        if grad_mode:
            lik_old = lik_cache["v"]
            if newton_mode and not frozen:
                lik_new, grad_new, hess_new = lik_value_grad_hess(
                    beta_new, data
                )
            else:
                lik_new, grad_new = lik_value_and_grad(beta_new, data)
                hess_new = lik_cache["h"] if newton_mode else xxt_bound
            f_new = _asis_joint_grad(grad_new, diff_new, mu_new, lt_new)
            L_new = chol_packed(
                _asis_joint_metric(hess_new, diff_new, lt_new), q
            )
            mean_new = th_new + drift * spd_solve(L_new, f_new, q)
            w_rev = lt_vec(L_new, th_old - mean_new, q)
            # the forward whitened residual is exactly s eps_q; the
            # 1/(2 s^2) normalisation cancels the s
            inv_2s2 = 0.5 if newton_mode else 0.5 / (s * s)[:, 0]
            q_corr = (
                -inv_2s2 * torch.sum(w_rev * w_rev, dim=-1)
                + half_logdet(L_new, q)
                + 0.5 * torch.sum(eps_q * eps_q, dim=-1)
                - half_logdet(L_old, q)
            )
        else:
            lik_new = lik_fn(beta_new, data)             # (C, G)
            lik_old = lik_cache
            if lik_old is None:
                lik_old = lik_fn(beta, data)
            q_corr = 0.0
        prior_delta = torch.sum(
            _tau_logprior(lt_new) + log_scale_guard(lt_new)
            - _tau_logprior(lt),
            dim=-1,
        )
        if grad_mode:
            prior_delta = prior_delta + torch.sum(
                -0.5 * (mu_new * mu_new - mu * mu) * inv_s0_2, dim=-1
            )
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
        }
        cache_up = {}
        if grad_mode:
            pos_up["mu"] = torch.where(acc2, mu_new, mu)
            cache_up["beta"] = {
                "v": torch.where(acc2, lik_new, lik_old),
                "g": torch.where(acc3, grad_new, lik_cache["g"]),
            }
            if newton_mode:
                cache_up["beta"]["h"] = (
                    lik_cache["h"] if frozen
                    else torch.where(acc3, hess_new, lik_cache["h"])
                )
        elif lik_cache is not None:
            cache_up["beta"] = torch.where(acc2, lik_new, lik_old)
        alpha = torch.where(
            torch.isnan(log_alpha), torch.zeros_like(log_alpha),
            torch.exp(log_alpha.clamp_max(0.0)),
        )
        return pos_up, cache_up, alpha

    def gibbs_mu(rng, state, data):
        """Exact conjugate draw of mu | beta, tau per coordinate."""
        s1, _ = _suff(state["beta"])
        inv_tau2 = torch.exp(-2.0 * state["log_tau"])
        prec = G * inv_tau2 + inv_s0_2
        mean = s1 * inv_tau2 / prec
        return mean + rng.normal(mean.shape) / torch.sqrt(prec)

    def gibbs_log_tau(rng, state, data):
        """Exact conjugate draw (invgamma prior): tau_k^2 | beta, mu ~
        InvGamma(a + G/2, b + quad_k/2) as rate / Gamma(shape), returned as
        log tau and clipped to [-12, 12] (the log_scale_guard support)."""
        s1, s2 = _suff(state["beta"])
        quad = _quad(s1, s2, state["mu"])
        rate = b_ig + 0.5 * quad
        g = rng.gamma(a_ig + 0.5 * G, quad.shape)
        return torch.clamp(
            0.5 * (torch.log(rate) - torch.log(g)), -12.0, 12.0
        )

    def joint(state, data):
        return (
            torch.sum(lik_fn(state["beta"], data), dim=-1)
            + torch.sum(_gprior(state), dim=-1)
            + torch.sum(logpdf_normal(state["mu"], 0.0, prior_mu_scale),
                        dim=-1)
            + torch.sum(_tau_logprior(state["log_tau"]), dim=-1)
        )

    def init_state(rng, data, chains):
        return {
            "beta": 0.5 * rng.normal((chains, G, p)),
            "mu": 0.5 * rng.normal((chains, p)),
            "log_tau": -0.5 + 0.3 * rng.normal((chains, p)),
        }

    def prior_sample(rng, data, chains):
        """An exact draw from the prior of the chosen tau prior."""
        mu = prior_mu_scale * rng.normal((chains, p))
        if conj_tau:
            tau = torch.sqrt(b_ig / rng.gamma(a_ig, (chains, p)))
        else:
            tau = prior_tau_scale * torch.abs(rng.normal((chains, p)))
        beta = mu[:, None, :] + tau[:, None, :] * rng.normal((chains, G, p))
        return {"beta": beta, "mu": mu, "log_tau": torch.log(tau)}

    def sample_data(rng, state, data):
        """Bernoulli responses given chain 0's beta, in the form of
        ``data`` (zero where masked): y = [log u < log sigmoid(eta)]."""
        beta = state["beta"][0]                          # (G, p)
        if ragged:
            eta = torch.sum(beta.index_select(0, data.segment_ids) * data.x,
                            dim=-1)
            y = (rng.log_uniform(eta.shape)
                 < torch.nn.functional.logsigmoid(eta)).float()
            return RaggedData(y=y, segment_ids=data.segment_ids,
                              num_groups=data.num_groups, x=data.x,
                              offsets=data.offsets)
        eta = torch.einsum("gnp,gp->gn", data.x, beta)
        y = (rng.log_uniform(eta.shape)
             < torch.nn.functional.logsigmoid(eta)).float()
        return NestedData(y=y * data.mask, mask=data.mask, sizes=data.sizes,
                          x=data.x, extra=data.extra)

    return ModelSpec(
        name="hier_logistic",
        blocks=(
            Block("beta", (G, p), units=G, init_scale=0.3),
            Block("mu", (p,), units=p, init_scale=0.2),
            Block("log_tau", (p,), units=p, init_scale=0.2, repeats=4),
        ),
        init_state=init_state,
        cond_logdensity=cond,
        joint_logdensity=joint,
        prior_sample=prior_sample,
        sample_data=sample_data,
        cond_value_and_grad=cond_value_and_grad,
        cond_cached={
            "beta": (
                lik_fn,
                lambda v, state, data: _gprior({**state, "beta": v}),
            ),
        },
        cond_cached_grad={"beta": (lik_value_and_grad, gprior_value_and_grad)},
        gibbs_draws={
            "mu": gibbs_mu,
            **({"log_tau": gibbs_log_tau} if conj_tau else {}),
        },
        joint_moves=(
            {"asis_tau": asis_tau_move} if asis_repeats > 0 else {}
        ),
        joint_move_repeats={"asis_tau": max(1, int(asis_repeats))},
        joint_move_init_scale={
            "asis_tau": 2.38 / math.sqrt(p * max(G, 1)),
        },
        joint_move_init_scale_grad={"asis_tau": 1.0},
        joint_move_target_accept={"asis_tau": "auto"},
        # ragged data: the fused MALA and Newton steps run per bucket, and
        # only on the bucket route with every group covered; the RW fused
        # step stays padded-only, as in the reference
        fused_updates={} if ragged else {"beta": fused_beta_update},
        fused_updates_mala=(
            {"beta": fused_mala_beta_update}
            if bucket_full or not ragged else {}
        ),
        fused_updates_newton=(
            {"beta": fused_newton_beta_update}
            if bucket_full or not ragged else {}
        ),
        cond_cached_newton={"beta": (lik_value_grad_hess, gprior_vgh)},
        loglik_impls={"selected": chosen},
    )


def synth_logistic(seed, G: int = 100, n: int = 50, p: int = 4,
                   ragged: bool = False, min_obs: int = 5, device="cuda"):
    """Synthetic hierarchical-logistic data from the reference's generative
    model, drawn with a numpy Generator seeded by ``seed``. ``ragged``:
    group sizes uniform on [min_obs, n], each group keeping its first
    sizes[g] observations, as flat RaggedData. Returns (NestedData or
    RaggedData on ``device``, the card unless the caller asks for another;
    truth dict of numpy arrays)."""
    r = np.random.default_rng(seed)
    mu = 0.5 * r.standard_normal(p)
    tau = 0.3 + 0.3 * np.abs(r.standard_normal(p))
    beta = mu + tau * r.standard_normal((G, p))
    x = r.standard_normal((G, n, p)).astype(np.float32)
    x[:, :, 0] = 1.0  # intercept column
    eta = np.einsum("gnp,gp->gn", x, beta)
    y = (r.random((G, n)) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float32)
    truth = {"mu": mu, "tau": tau, "beta": beta}
    if not ragged:
        data = from_numpy(x, y, np.ones((G, n), np.float32), device=device)
        return data, truth
    sizes = r.integers(min_obs, n + 1, size=G)
    keep = np.arange(n)[None, :] < sizes[:, None]          # (G, n)
    seg = np.repeat(np.arange(G), sizes)
    return from_numpy_ragged(x[keep], y[keep], seg, G, device=device), truth
