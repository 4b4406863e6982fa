"""The plain reference of one sampling sweep of the hierarchical logistic
model, in plain PyTorch and numpy (it imports nothing of the program).

Given a carry (positions and proposal scales) and the run's noise sources
as they stood before a sweep, it works out the sweep the sampler has to
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

Noise, as the sampler defines it:
- the group block's (C, G, p) proposal noise and (C, G) log-uniforms come
  from Philox-4x32-10 keyed by the launch's two key words, drawn from the
  run's host generator: on the card inside the step (cell (c, g) at
  counter c * G + g, 2p + 1 uniforms from counters (cell, 0) and (cell, 1),
  Box-Muller cos branch on uniform pairs, log of the last), on the CPU from
  two counter-indexed fills (element e of the flat tensor is word e & 3 of
  the call at counter e >> 2; normals Box-Muller on both branches), one
  key each;
- every draw without a unit axis ((C, p), (C, 2p), (C,) normals, uniforms
  and gammas) from the run's device generator, at the global shape, in
  the sweep's order.

``Model.tf32`` False: the configuration's float32, TF32 off (and
:func:`no_tf32` keeps the library's TF32 off); True: the control, the
same arithmetic with the inputs of its matrix products rounded to TF32,
the nearest precision below the configuration's, as a TF32 product takes
them.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

_LOG_2PI = math.log(2.0 * math.pi)
_TINY = torch.finfo(torch.float32).tiny
_M32 = 0xFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)
_WEYL = (0x9E3779B9, 0xBB67AE85)


@contextlib.contextmanager
def no_tf32():
    """The library's TF32 matrix products off inside the block (the
    reference's float32 products are float32; its control rounds their
    inputs itself)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---- Philox-4x32-10 ----

def philox(counter: torch.Tensor, k0: int, k1: int) -> tuple:
    """The four output words (int64 holding uint32) at counters (counter
    mod 2^32, counter >> 32, 0, 0), key (k0, k1)."""
    x, y = counter & _M32, (counter >> 32) & _M32
    z, w = torch.zeros_like(counter), torch.zeros_like(counter)
    for r in range(10):
        ka = (k0 + r * _WEYL[0]) & _M32
        kb = (k1 + r * _WEYL[1]) & _M32
        p0 = x * _MUL[0]
        p1 = z * _MUL[1]
        hi0, lo0 = (p0 >> 32) & _M32, p0 & _M32
        hi1, lo1 = (p1 >> 32) & _M32, p1 & _M32
        x, y, z, w = hi1 ^ y ^ ka, lo1, hi0 ^ w ^ kb, lo0
    return x, y, z, w


def _unit(bits):
    """Top 24 bits to (0, 1]: (b >> 8) 2^-24 + 2^-25 rounded once to
    float32, as the kernels convert them; returned in float64 for the
    transcendental functions that follow."""
    return ((bits >> 8).to(torch.float64) * 2.0 ** -24
            + 2.0 ** -25).float().double()


def step_noise_kernel(key, c0: int, C: int, G: int, p: int, device):
    """(eps (C, G, p), log u (C, G)) of chains c0 .. c0 + C - 1 of the
    fused step's in-kernel Philox draws, float32."""
    k0, k1 = (int(v) & _M32 for v in key)
    c = torch.arange(c0, c0 + C, dtype=torch.int64, device=device)
    cell = (c[:, None] * G + torch.arange(G, dtype=torch.int64,
                                          device=device)[None, :])
    uni = []
    for blk in range((2 * p + 1 + 3) // 4):
        uni.extend(_unit(wd) for wd in philox(cell + (blk << 32), k0, k1))
    eps = torch.stack([
        torch.sqrt(-2.0 * torch.log(uni[2 * k]))
        * torch.cos(2.0 * math.pi * uni[2 * k + 1]) for k in range(p)],
        dim=-1)
    logu = torch.log(uni[2 * p])
    return eps.float(), logu.float()


def fill(shape, key, c0: int, mode: str, device):
    """Rows c0 .. of the counter-indexed fill of a (C_total, *rest) tensor:
    element e of the flat tensor takes word e & 3 of the call at counter
    e >> 2; 'normal' (Box-Muller on both branches of each word pair) or
    'log_uniform', float32."""
    k0, k1 = (int(v) & _M32 for v in key)
    rows = int(shape[0])
    K = int(np.prod(shape[1:]))
    e = (c0 * K + torch.arange(rows * K, dtype=torch.int64, device=device))
    q, lane = e >> 2, e & 3
    x, y, z, w = philox(q, k0, k1)
    if mode == "log_uniform":
        words = torch.stack([x, y, z, w])
        out = torch.log(_unit(words.gather(0, lane[None])[0]))
    else:
        first = torch.where(lane < 2, x, z)
        second = torch.where(lane < 2, y, w)
        r = torch.sqrt(-2.0 * torch.log(_unit(first)))
        t = 2.0 * math.pi * _unit(second)
        out = torch.where(lane % 2 == 0, r * torch.cos(t), r * torch.sin(t))
    return out.float().reshape(tuple(shape))


# ---- the Cholesky algebra of small packed matrices ----

def _pi(i, j):
    if j > i:
        i, j = j, i
    return i * (i + 1) // 2 + j


def pack_diag(d, p):
    zero = torch.zeros_like(d[..., 0])
    return torch.stack([d[..., i] if i == j else zero
                        for i in range(p) for j in range(i + 1)], dim=-1)


def chol(a, p):
    L = [None] * (p * (p + 1) // 2)
    for j in range(p):
        s = a[..., _pi(j, j)]
        for k in range(j):
            s = s - L[_pi(j, k)] * L[_pi(j, k)]
        L[_pi(j, j)] = torch.sqrt(s)
        inv = 1.0 / L[_pi(j, j)]
        for i in range(j + 1, p):
            s = a[..., _pi(i, j)]
            for k in range(j):
                s = s - L[_pi(i, k)] * L[_pi(j, k)]
            L[_pi(i, j)] = s * inv
    return torch.stack(L, dim=-1)


def solve_lower(L, b, p):
    y = [None] * p
    for i in range(p):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., _pi(i, k)] * y[k]
        y[i] = s / L[..., _pi(i, i)]
    return torch.stack(y, dim=-1)


def solve_upper_t(L, b, p):
    x = [None] * p
    for i in reversed(range(p)):
        s = b[..., i]
        for k in range(i + 1, p):
            s = s - L[..., _pi(k, i)] * x[k]
        x[i] = s / L[..., _pi(i, i)]
    return torch.stack(x, dim=-1)


def spd_solve(L, b, p):
    return solve_upper_t(L, solve_lower(L, b, p), p)


def lt_vec(L, v, p):
    out = []
    for i in range(p):
        s = L[..., _pi(i, i)] * v[..., i]
        for k in range(i + 1, p):
            s = s + L[..., _pi(k, i)] * v[..., k]
        out.append(s)
    return torch.stack(out, dim=-1)


def half_logdet(L, p):
    s = torch.log(L[..., 0])
    for k in range(1, p):
        s = s + torch.log(L[..., _pi(k, k)])
    return s


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


def accept_prob(log_alpha):
    """min(1, exp(log alpha)), NaN -> 0: the acceptance probability the
    Robbins-Monro update reads."""
    a = torch.exp(log_alpha.clamp_max(0.0))
    return torch.where(torch.isnan(log_alpha), torch.zeros_like(a), a)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away
    from zero), as a TF32 matrix product rounds its inputs."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(eq, a, b, tf32):
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return torch.einsum(eq, a, b)


def logp_grad(beta, d: Data, hess: bool = False, tf32: bool = False):
    """(loglik (C, G), gradient (C, G, p)[, packed -Hessian (C, G, T)]) of
    the Bernoulli-logit observations at ``beta`` (C, G, p); its three
    contractions are matrix products, with TF32 inputs when ``tf32``."""
    eta = _mm("cgp,gnp->cgn", beta, d.x, tf32)
    e = torch.exp(-eta.abs())
    sp = eta.clamp_min(0.0) + torch.log1p(e)
    inv = 1.0 / (1.0 + e)
    sig = torch.where(eta >= 0.0, inv, e * inv)
    ll = ((d.y * eta - sp) * d.mask).sum(dim=-1)
    grad = _mm("cgn,gnp->cgp", (d.y - sig) * d.mask, d.x, tf32)
    if not hess:
        return ll, grad.contiguous()
    w = e * inv * inv * d.mask
    return ll, grad.contiguous(), _mm("cgn,gnt->cgt", w, d.xx,
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
        self.hidx = torch.tensor([[_pi(i, j) for j in range(p)]
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


def chain_blocks(C: int, G: int, n: int, budget: int = 1 << 25):
    """Chain slices whose (chains, G, n) temporaries hold ``budget``
    elements at most."""
    step = max(1, budget // max(1, G * n))
    return [(c, min(C, c + step)) for c in range(0, C, step)]


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


def advance_keys(host_state, sweeps: int, keys: int) -> torch.Tensor:
    """The key-word generator's state after ``sweeps`` sweeps that each
    take ``keys`` pairs of words, from ``host_state``."""
    host = torch.Generator()
    host.set_state(host_state)
    for _ in range(sweeps):
        torch.randint(0, 2 ** 32, (keys, 2), generator=host,
                      dtype=torch.int64)
    return host.get_state()


# ---- split R-hat of collected draws ----

def split_rhat(draws: torch.Tensor, rthin: int) -> torch.Tensor:
    """Classic split R-hat of the draws the streamed accumulators fold:
    every rthin-th retained draw, the first 2 * half of them split in two
    halves; float64. draws (C, D, ...) -> (...)."""
    x = draws[:, ::rthin].double()
    half = x.shape[1] // 2
    x = x[:, :2 * half]
    seqs = torch.cat([x[:, :half], x[:, half:]])
    w = torch.var(seqs, dim=1, correction=1).mean(0)
    b = half * torch.var(seqs.mean(1), dim=0, correction=1)
    var_plus = (half - 1.0) / half * w + b / half
    return torch.sqrt(var_plus / torch.where(w > 0, w, torch.ones_like(w)))


def split_rhat_tf32(draws: torch.Tensor, rthin: int) -> torch.Tensor:
    """The control of the streamed accumulators: the same split R-hat from
    Welford accumulators held in TF32 (each running mean and sum of squares
    rounded to a 10-bit mantissa after every update)."""
    x = draws[:, ::rthin].float()
    half = x.shape[1] // 2
    seqs = torch.cat([x[:, :half], x[:, half:2 * half]])
    mean = torch.zeros_like(seqs[:, 0])
    m2 = torch.zeros_like(seqs[:, 0])
    for t in range(half):
        xt = seqs[:, t]
        delta = xt - mean
        mean = tf32_round(mean + delta / (t + 1))
        m2 = tf32_round(m2 + delta * (xt - mean))
    n = float(half)
    w = (m2 / max(n - 1.0, 1.0)).double().mean(0)
    b = n * torch.var(mean.double(), dim=0, correction=1)
    var_plus = (n - 1.0) / n * w + b / n
    return torch.sqrt(var_plus / torch.where(w > 0, w, torch.ones_like(w)))
