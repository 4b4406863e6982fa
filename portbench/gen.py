"""The benchmark's data: a frozen copy of the synthetic hierarchical-logistic
generator (numpy only), so that a later change to the program's own
generator cannot move the yardstick.

    mu ~ 0.5 N(0, 1)^p, tau = 0.3 + 0.3 |N(0, 1)|^p, beta_g ~ N(mu, tau^2)
    x_gi ~ N(0, 1)^p with x_gi0 = 1, y_gi ~ Bernoulli(sigmoid(x_gi . beta_g))
"""

from __future__ import annotations

import numpy as np


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
