"""The plain reference of the hierarchical logistic model (portbench/models/
hier_logistic.py), in plain PyTorch and numpy (it imports nothing of the
program): its data generator and one sampling sweep.

The data: a frozen copy of the synthetic hierarchical-logistic generator
(numpy only), so that a later change to the program's own generator
cannot move the yardstick.

    mu ~ 0.5 N(0, 1)^p, tau = 0.3 + 0.3 |N(0, 1)|^p, beta_g ~ N(mu, tau^2)
    x_gi ~ N(0, 1)^p with x_gi0 = 1, y_gi ~ Bernoulli(sigmoid(x_gi . beta_g))

The sweep: given a carry (positions and proposal scales) and the run's
noise sources as they stood before a sweep, the sweep the sampler has to
make: the group block (Newton-MH or MALA), the exact mu draw, log tau (the
inverse-gamma conjugate draw, or four MALA updates under the half-normal
prior) and the (mu, log tau) interweaving move (Laplace with the likelihood
Hessian, or Langevin with the data-constant bound metric), each by the
model's equations. A sampling sweep holds Newton's Hessian frozen at the
one it is given; a warmup sweep refreshes it at each proposal (the step's
reverse move and the Laplace move's reverse metric) and updates the MALA
scales by Robbins-Monro, log s + c (t + 1 + t0)^-kappa (alpha - target),
clipped to [-12, 8]. Its caches (loglik, gradient, Hessian) it works out
again from the positions and its own copy of the data; it takes none of
the program's.

Noise (portbench/reference.py): the group block's (C, G, p) proposal
noise and (C, G) log-uniforms from the fused step's Philox draws, or two
fills on the CPU; the (C, p), (C, 2p), (C,) normals, uniforms and gammas
from the run's device generator, at the global shape, in the sweep's
order.

``Model.tf32`` False: the configuration's float32, TF32 off; True: the
control, the same arithmetic with the inputs of its matrix products
rounded to TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import (
    accept_prob,
    chain_blocks,
    chol,
    fill,
    half_logdet,
    lt_vec,
    mm,
    pack_diag,
    pack_index,
    solve_upper_t,
    spd_solve,
    step_noise_kernel,
)

_LOG_2PI = math.log(2.0 * math.pi)
_TINY = torch.finfo(torch.float32).tiny


# ---- the data ----

def synth_logistic(seed: int, G: int, n: int, p: int) -> dict:
    """{'x' (G, n, p), 'y' (G, n), 'mask' (G, n)} float32 arrays drawn with
    a numpy Generator seeded by ``seed``, in the order the program's
    generator draws them; every group holds all n observations."""
    r = np.random.default_rng(seed)
    mu = 0.5 * r.standard_normal(p)
    tau = 0.3 + 0.3 * np.abs(r.standard_normal(p))
    beta = mu + tau * r.standard_normal((G, p))
    x = r.standard_normal((G, n, p)).astype(np.float32)
    x[:, :, 0] = 1.0
    eta = np.einsum("gnp,gp->gn", x, beta)
    y = (r.random((G, n)) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float32)
    return {"x": x, "y": y, "mask": np.ones((G, n), np.float32)}


# ---- the Bernoulli-logit observations ----

class Data:
    """The benchmark's data on ``device``: x (G, n, p), y and mask (G, n),
    with the pair products x_i x_j (G, n, T) and the data-constant bound
    of the Hessian 0.25 sum_i mask x x^T (1, G, T)."""

    def __init__(self, arrays: dict, device):
        x = np.asarray(arrays["x"], np.float32)
        mask = np.asarray(arrays["mask"], np.float32)
        self.G, self.n, self.p = x.shape
        p = self.p
        self.x = torch.as_tensor(x, device=device)
        self.y = torch.as_tensor(np.asarray(arrays["y"], np.float32),
                                 device=device)
        self.mask = torch.as_tensor(mask, device=device)
        self.xx = torch.stack([self.x[..., i] * self.x[..., j]
                               for i in range(p) for j in range(i + 1)], -1)
        xd, md = x.astype(np.float64), mask.astype(np.float64)
        cols = [0.25 * np.sum(md * xd[:, :, i] * xd[:, :, j], axis=1)
                for i in range(p) for j in range(i + 1)]
        self.bound = torch.tensor(np.stack(cols, -1), dtype=torch.float32,
                                  device=device)[None]


def logp_grad(beta, d: Data, hess: bool = False, tf32: bool = False):
    """(loglik (C, G), gradient (C, G, p)[, packed -Hessian (C, G, T)]) of
    the Bernoulli-logit observations at ``beta`` (C, G, p); its three
    contractions are matrix products, with TF32 inputs when ``tf32``."""
    eta = mm("cgp,gnp->cgn", beta, d.x, tf32)
    e = torch.exp(-eta.abs())
    sp = eta.clamp_min(0.0) + torch.log1p(e)
    inv = 1.0 / (1.0 + e)
    sig = torch.where(eta >= 0.0, inv, e * inv)
    ll = ((d.y * eta - sp) * d.mask).sum(dim=-1)
    grad = mm("cgn,gnp->cgp", (d.y - sig) * d.mask, d.x, tf32)
    if not hess:
        return ll, grad.contiguous()
    w = e * inv * inv * d.mask
    return ll, grad.contiguous(), mm("cgn,gnt->cgt", w, d.xx,
                                      tf32).contiguous()


# ---- one sweep ----

class Model:
    """The model's constants from a configuration dict (the keys of a
    portbench/configs file)."""

    def __init__(self, cfg: dict, data: Data):
        self.d = data
        self.G, self.p = data.G, data.p
        self.q = 2 * self.p
        self.algorithm = cfg["algorithm"]
        self.tf32 = False
        self.conj = cfg["tau_prior"] == "invgamma"
        self.a = float(cfg["tau_ig_shape"])
        self.b = float(cfg["tau_ig_scale"])
        self.inv_s0_2 = 1.0 / float(cfg["prior_mu_scale"]) ** 2
        self.S = float(cfg["prior_tau_scale"])
        self.inv_S2 = 1.0 / self.S ** 2
        self.lt_repeats = 4
        ad = cfg["adapt"]
        self.rm = (float(ad["c"]), float(ad["t0"]), float(ad["kappa"]))
        self.mala_target = float(ad["mala_target"])
        self.lp_const = self.a * math.log(self.b) - math.lgamma(self.a)
        p, q = self.p, self.q
        dev = data.x.device
        self.hidx = torch.tensor([[pack_index(i, j) for j in range(p)]
                                  for i in range(p)], device=dev)
        self.qidx = torch.tensor([i * q + j for i in range(q)
                                  for j in range(i + 1)], device=dev)
        self.eye = torch.eye(p, device=dev)

    # priors of log tau, with the Jacobian, and their derivatives
    def tau_lp(self, lt):
        if self.conj:
            return (self.lp_const - 2.0 * (self.a + 1.0) * lt
                    - self.b * torch.exp(-2.0 * lt) + math.log(2.0)
                    + 2.0 * lt)
        z = torch.exp(lt) / self.S
        return (-0.5 * (z * z + _LOG_2PI) + math.log(2.0)
                - math.log(self.S) + lt)

    def tau_lp_grad(self, lt):
        if self.conj:
            return -2.0 * self.a + 2.0 * self.b * torch.exp(-2.0 * lt)
        return 1.0 - torch.exp(2.0 * lt) * self.inv_S2

    def tau_lp_metric(self, lt):
        if self.conj:
            return 4.0 * self.b * torch.exp(-2.0 * lt)
        return 2.0 * torch.exp(2.0 * lt) * self.inv_S2

    # Robbins-Monro, warmup only
    def gain(self, t: int) -> torch.Tensor:
        """The gain of warmup sweep ``t`` (0-based), float32."""
        c, t0, kappa = self.rm
        return torch.tensor(c * (t + 1.0 + t0) ** (-kappa),
                            dtype=torch.float32, device=self.d.x.device)

    def adapt(self, log_scale, alpha, gain):
        return torch.clamp(log_scale + gain * (alpha - self.mala_target),
                           -12.0, 8.0)

    @staticmethod
    def guard(lt):
        return torch.where(lt.abs() < 12.0, torch.zeros_like(lt),
                           torch.full_like(lt, -math.inf))

    # the group block
    def newton(self, beta, v, g, h, log_scale, mu, lt, eps, logu,
               refresh: bool):
        """Newton-MH with the Hessian ``h`` of beta; ``refresh``: the
        reverse move takes the proposal's own Hessian (warmup), else ``h``
        (the frozen metric). Returns (beta, v, g, h, alpha)."""
        p = self.p
        itau2 = torch.exp(-2.0 * lt)[:, None, :]
        h_prior = pack_diag(itau2, p)
        sc = torch.exp(log_scale)[..., None]
        inv_c = torch.exp(-2.0 * log_scale)
        db = beta - mu[:, None, :]
        L_old = chol(h + h_prior, p)
        mean_old = beta + spd_solve(L_old, g - db * itau2, p)
        prop = mean_old + sc * solve_upper_t(L_old, eps, p)
        if refresh:
            v_new, g_new, h_new = logp_grad(prop, self.d, hess=True,
                                            tf32=self.tf32)
            L_new = chol(h_new + h_prior, p)
        else:
            v_new, g_new = logp_grad(prop, self.d, tf32=self.tf32)
            h_new, L_new = h, L_old
        dp = prop - mu[:, None, :]
        mean_new = prop + spd_solve(L_new, g_new - dp * itau2, p)
        w_rev = lt_vec(L_new, beta - mean_new, p)
        quad = torch.sum(-0.5 * (dp * dp - db * db) * itau2, dim=-1)
        log_alpha = (v_new - v + quad) + 0.5 * (
            torch.sum(eps * eps, dim=-1)
            - inv_c * torch.sum(w_rev * w_rev, dim=-1))
        if refresh:
            log_alpha = (log_alpha + half_logdet(L_new, p)
                         - half_logdet(L_old, p))
        acc = logu < log_alpha
        return (torch.where(acc[..., None], prop, beta),
                torch.where(acc, v_new, v),
                torch.where(acc[..., None], g_new, g),
                torch.where(acc[..., None], h_new, h) if refresh else h,
                accept_prob(log_alpha))

    def mala(self, beta, v, g, log_scale, mu, lt, eps, logu):
        itau2 = torch.exp(-2.0 * lt)[:, None, :]
        s = torch.exp(log_scale)[..., None]
        s2 = s * s
        mu3 = mu[:, None, :]
        db = beta - mu3
        prop = beta + 0.5 * s2 * (g - db * itau2) + s * eps
        v_new, g_new = logp_grad(prop, self.d, tf32=self.tf32)
        dp = prop - mu3
        d_delta = v_new - v + torch.sum(-0.5 * (dp * dp - db * db) * itau2,
                                        dim=-1)
        rev = beta - prop - 0.5 * s2 * (g_new - dp * itau2)
        fwd = s * eps
        q_delta = torch.sum(fwd * fwd - rev * rev, dim=-1) / (
            2.0 * torch.exp(2.0 * log_scale))
        log_alpha = d_delta + q_delta
        acc = logu < log_alpha
        return (torch.where(acc[..., None], prop, beta),
                torch.where(acc, v_new, v),
                torch.where(acc[..., None], g_new, g),
                accept_prob(log_alpha))

    # the population blocks
    def quad(self, s1, s2, mu):
        return s2 - 2.0 * mu * s1 + self.G * mu * mu

    def gibbs_mu(self, s1, lt, eps):
        inv_tau2 = torch.exp(-2.0 * lt)
        prec = self.G * inv_tau2 + self.inv_s0_2
        return s1 * inv_tau2 / prec + eps / torch.sqrt(prec)

    def gibbs_log_tau(self, s1, s2, mu, gamma):
        rate = self.b + 0.5 * self.quad(s1, s2, mu)
        return torch.clamp(0.5 * (torch.log(rate) - torch.log(gamma)),
                           -12.0, 12.0)

    def _lt_cond(self, value, s1, s2, mu):
        quad_tau2 = self.quad(s1, s2, mu) / torch.exp(2.0 * value)
        val = (-0.5 * quad_tau2 - self.G * value - 0.5 * self.G * _LOG_2PI
               + self.tau_lp(value) + self.guard(value))
        return val, quad_tau2 - self.G + self.tau_lp_grad(value)

    def mala_log_tau(self, lt, log_scale, s1, s2, mu, eps, u):
        s = torch.exp(log_scale)
        s2_ = s * s
        d_old, g_old = self._lt_cond(lt, s1, s2, mu)
        prop = lt + 0.5 * s2_ * g_old + s * eps
        d_new, g_new = self._lt_cond(prop, s1, s2, mu)
        fwd = prop - lt - 0.5 * s2_ * g_old
        rev = lt - prop - 0.5 * s2_ * g_new
        log_alpha = d_new - d_old + (fwd * fwd - rev * rev) / (
            2.0 * torch.exp(2.0 * log_scale))
        logu = torch.log(u.clamp_min(_TINY))
        return torch.where(logu < log_alpha, prop, lt), accept_prob(log_alpha)

    # the interweaving move
    def _joint_grad(self, g_lik, diff, mu, lt):
        return torch.cat([g_lik.sum(1) - mu * self.inv_s0_2,
                          (g_lik * diff).sum(1) + self.tau_lp_grad(lt)], -1)

    def _joint_metric(self, h, diff, lt):
        p, q = self.p, self.q
        C = diff.shape[0]
        H = h[..., self.hidx]
        dk = diff[..., :, None]
        m_mm = (H.sum(1) + self.inv_s0_2 * self.eye).expand(C, p, p)
        m_lm = (H * dk).sum(1)
        m_ll = (H * dk * diff[..., None, :]).sum(1) + torch.diag_embed(
            self.tau_lp_metric(lt))
        M = torch.cat([torch.cat([m_mm, m_lm.transpose(-1, -2)], -1),
                       torch.cat([m_lm, m_ll], -1)], -2)
        return M.reshape(C, q * q)[:, self.qidx]

    def interweave(self, beta, mu, lt, v, g, h, scale, eps_q, u,
                   refresh: bool = False):
        """h: the Hessian of beta (Laplace move; ``refresh``: the reverse
        metric from the proposal's own Hessian, else from ``h``) or None
        (Langevin with the bound metric, ``scale`` (C, 1)). Returns (beta,
        mu, log tau, h, alpha)."""
        q = self.q
        newton = h is not None
        diff = beta - mu[:, None, :]
        h_src = h if newton else self.d.bound
        if newton:
            s, drift = 1.0, 1.0
        else:
            s = scale
            drift = 0.5 * s * s
        f_old = self._joint_grad(g, diff, mu, lt)
        L_old = chol(self._joint_metric(h_src, diff, lt), q)
        th_old = torch.cat([mu, lt], -1)
        mean_old = th_old + drift * spd_solve(L_old, f_old, q)
        th_new = mean_old + s * solve_upper_t(L_old, eps_q, q)
        mu_new, lt_new = th_new[:, :self.p], th_new[:, self.p:]
        diff_new = diff * torch.exp(lt_new - lt)[:, None, :]
        beta_new = mu_new[:, None, :] + diff_new
        refresh = refresh and newton
        if refresh:
            lik_new, grad_new, h_new = logp_grad(beta_new, self.d, hess=True,
                                                 tf32=self.tf32)
        else:
            lik_new, grad_new = logp_grad(beta_new, self.d, tf32=self.tf32)
            h_new = h_src
        f_new = self._joint_grad(grad_new, diff_new, mu_new, lt_new)
        L_new = chol(self._joint_metric(h_new, diff_new, lt_new), q)
        mean_new = th_new + drift * spd_solve(L_new, f_new, q)
        w_rev = lt_vec(L_new, th_old - mean_new, q)
        inv_2s2 = 0.5 if newton else 0.5 / (s * s)[:, 0]
        q_corr = (-inv_2s2 * torch.sum(w_rev * w_rev, -1)
                  + half_logdet(L_new, q) + 0.5 * torch.sum(eps_q * eps_q, -1)
                  - half_logdet(L_old, q))
        prior_delta = torch.sum(self.tau_lp(lt_new) + self.guard(lt_new)
                                - self.tau_lp(lt), -1) + torch.sum(
            -0.5 * (mu_new * mu_new - mu * mu) * self.inv_s0_2, -1)
        log_alpha = (lik_new - v).sum(-1) + prior_delta + q_corr
        acc = torch.log(u.clamp_min(_TINY)) < log_alpha
        return (torch.where(acc[:, None, None], beta_new, beta),
                torch.where(acc[:, None], mu_new, mu),
                torch.where(acc[:, None], lt_new, lt),
                torch.where(acc[:, None, None], h_new, h) if refresh else h,
                accept_prob(log_alpha))


# key word pairs a sweep takes from the host generator: one launch of the
# fused step on the card, two fills on the CPU
KEYS = {"kernel": 1, "fill": 2}


class Noise:
    """The noise one sweep takes, drawn from copies of the run's two
    generators as they stood before it: the group step's key words (one
    pair in 'kernel' mode, two in 'fill' mode), then the device
    generator's draws in the sweep's order, at their global shapes."""

    def __init__(self, model: Model, C: int, host_state, device_state,
                 device, mode: str):
        host = torch.Generator()
        host.set_state(host_state)
        w = torch.randint(0, 2 ** 32, (KEYS[mode], 2), generator=host,
                          dtype=torch.int64)
        self.keys = [tuple(int(v) for v in row) for row in w]
        self.mode = mode
        gen = torch.Generator(device=device)
        gen.set_state(device_state)
        p, q = model.p, model.q

        def randn(shape):
            return torch.randn(shape, generator=gen, device=device)

        def rand(shape):
            return torch.rand(shape, generator=gen, device=device)

        self.mu_eps = randn((C, p))
        if model.conj:
            self.gamma = torch._standard_gamma(
                torch.full((C, p), model.a + 0.5 * model.G, device=device),
                generator=gen)
            self.lt = []
        else:
            self.gamma = None
            self.lt = []
            for _ in range(model.lt_repeats):
                e = randn((C, p))
                self.lt.append((e, rand((C, p))))
        self.asis_eps = randn((C, q))
        self.asis_u = rand((C,))

    def step(self, c0: int, C: int, G: int, p: int, device):
        """(eps, log u) of chains c0 .. c0 + C - 1 of the group step."""
        if self.mode == "kernel":
            return step_noise_kernel(self.keys[0], c0, C, G, p, device)
        return (fill((C, G, p), self.keys[0], c0, "normal", device),
                fill((C, G), self.keys[1], c0, "log_uniform", device))


def carry(model: Model, beta):
    """{'v', 'g'[, 'h']}: the caches of ``beta`` (C, G, p) the carry must
    hold, worked out in chain blocks (the Hessian for Newton-MH)."""
    newton = model.algorithm == "newton"
    parts = {"v": [], "g": []} | ({"h": []} if newton else {})
    for a, b in chain_blocks(beta.shape[0], model.G, model.d.n):
        out = logp_grad(beta[a:b], model.d, hess=newton,
                        tf32=model.tf32)
        for k, t in zip(parts, out):
            parts[k].append(t)
    return {k: torch.cat(v) for k, v in parts.items()}


STATE = ("beta", "mu", "log_tau", "log_scale_beta", "log_scale_lt",
         "log_scale_asis")


def sweep(model: Model, state: dict, noise: Noise, warmup: bool = False,
          t: int = 0, h=None) -> dict:
    """One sweep of every chain from ``state`` {'beta', 'mu', 'log_tau',
    'log_scale_beta', 'log_scale_lt' (C, p) or None, 'log_scale_asis'
    (C, 1) or None}; returns the new state (the same keys).

    warmup: the adapting sweep ``t`` (0-based): Newton's Hessian refreshed
    at each proposal, the MALA scales updated by Robbins-Monro; else the
    sampling sweep, Newton's Hessian frozen at ``h`` (C, G, T)."""
    d = model.d
    G, p = model.G, model.p
    dev = d.x.device
    newton = model.algorithm == "newton"
    gain = model.gain(t) if warmup else None
    C = state["beta"].shape[0]
    out = {k: [] for k in STATE if state.get(k) is not None}
    for a, b in chain_blocks(C, G, d.n):
        beta = state["beta"][a:b]
        mu, lt = state["mu"][a:b], state["log_tau"][a:b]
        ls = {k: state[k][a:b] for k in STATE[3:]
              if state.get(k) is not None}
        if newton and not warmup:
            v, g = logp_grad(beta, d, tf32=model.tf32)
            hb = h[a:b]
        else:
            cache = carry(model, beta)
            v, g, hb = cache["v"], cache["g"], cache.get("h")
        eps, logu = noise.step(a, b - a, G, p, dev)
        if newton:
            beta, v, g, hb, _ = model.newton(
                beta, v, g, hb, ls["log_scale_beta"], mu, lt, eps, logu,
                refresh=warmup)
        else:
            beta, v, g, alpha = model.mala(beta, v, g, ls["log_scale_beta"],
                                           mu, lt, eps, logu)
            if warmup:
                ls["log_scale_beta"] = model.adapt(ls["log_scale_beta"],
                                                   alpha, gain)
        s1, s2 = beta.sum(1), (beta * beta).sum(1)
        mu = model.gibbs_mu(s1, lt, noise.mu_eps[a:b])
        if model.conj:
            lt = model.gibbs_log_tau(s1, s2, mu, noise.gamma[a:b])
        else:
            alphas = []
            for e, u in noise.lt:
                lt, alpha = model.mala_log_tau(lt, ls["log_scale_lt"], s1, s2,
                                               mu, e[a:b], u[a:b])
                alphas.append(alpha)
            if warmup:
                alpha = sum(alphas) / len(alphas)
                if alpha.shape[1] != ls["log_scale_lt"].shape[1]:
                    alpha = alpha.mean(dim=1, keepdim=True)
                ls["log_scale_lt"] = model.adapt(ls["log_scale_lt"], alpha,
                                                 gain)
        scale = None if newton else torch.exp(ls["log_scale_asis"])
        beta, mu, lt, hb, alpha = model.interweave(
            beta, mu, lt, v, g, hb if newton else None, scale,
            noise.asis_eps[a:b], noise.asis_u[a:b], refresh=warmup)
        if warmup and not newton:
            ls["log_scale_asis"] = model.adapt(ls["log_scale_asis"],
                                               alpha[:, None], gain)
        new = {"beta": beta, "mu": mu, "log_tau": lt, **ls}
        for k in out:
            out[k].append(new[k])
    return {k: torch.cat(v) for k, v in out.items()}


def collected(state: dict, collect: dict) -> dict:
    """The quantities a draw retains: {'mu', 'log_tau', 'beta' (C, k, p)}
    of ``state``."""
    return {"mu": state["mu"], "log_tau": state["log_tau"],
            "beta": state["beta"][:, :collect.get("beta", state["beta"]
                                                  .shape[1])]}
