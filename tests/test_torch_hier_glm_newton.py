"""kernels/newton.cond_value_grad_hess on the generic GLM's Newton split
(models/hier_glm.py), all five families.

Against the reference's nestmc.kernels.newton.cond_value_grad_hess on the
same data and position (tests/test_torch_hier_glm.py's helpers; rtol
1e-5, atol 1e-4), and the twin of tests/test_hier_glm_newton.py's first
tier: the hooks' (value, grad, packed -Hessian) against the conditional
and torch.autograd (value 2e-5, gradient 2e-4, Hessian blocks 3e-3, the
reference's tolerances) on synth_glm data (G=3, n=5, p=2, 2 chains).
"""

import numpy as np
import pytest
import torch

from nestmc.kernels.newton import cond_value_grad_hess as j_cvgh
from nestmc_torch.config import KernelConfig, RunConfig, SamplerConfig
from nestmc_torch.kernels.newton import cond_value_grad_hess
from nestmc_torch.kernels.state import init_kernel_state
from nestmc_torch.models import make_hier_glm, synth_glm
from nestmc_torch.ops.smallchol import packed_index
from nestmc_torch.rng import SweepRNG
from tests.test_torch_calibration import one_thread  # noqa: F401
from tests.test_torch_hier_glm import FAMILIES, _models, both, close, \
    glm_state


@pytest.mark.parametrize("family", FAMILIES)
def test_matches_reference(family):
    jdata, tdata, jm, tm = _models(family, fused=False)
    js, ts = both(glm_state(family))
    ours = cond_value_grad_hess(tm, "beta", ts["beta"], ts, tdata)
    ref = j_cvgh(jm, "beta", js["beta"], js, jdata)
    for o, r, what in zip(ours, ref, ("value", "grad", "hess")):
        assert tuple(o.shape) == tuple(np.shape(r)), what
        close(o, r, msg=what)


def _unpack(h, p):
    out = np.zeros(h.shape[:-1] + (p, p))
    for i in range(p):
        for j in range(i + 1):
            out[..., i, j] = out[..., j, i] = h[..., packed_index(i, j)]
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_vgh_hooks_match_autograd(family):
    data, _ = synth_glm(3, family=family, G=3, n=5, p=2, device="cpu")
    model = make_hier_glm(data, family=family)
    cfg = SamplerConfig(kernel=KernelConfig(algorithm="newton"),
                        run=RunConfig(chains=2, log_every_segment=False))
    pos = init_kernel_state(model, cfg, SweepRNG(1, "cpu"), data).position
    beta = pos["beta"]
    C, G, p = beta.shape
    v, g, h = cond_value_grad_hess(model, "beta", beta, pos, data)

    def cond_sum(b):
        return torch.sum(model.cond_logdensity("beta", b, pos, data))

    np.testing.assert_allclose(
        v.numpy(), model.cond_logdensity("beta", beta, pos, data).numpy(),
        rtol=2e-5, atol=2e-5)
    b = beta.detach().requires_grad_(True)
    (ref_g,) = torch.autograd.grad(cond_sum(b), b)
    np.testing.assert_allclose(g.numpy(), ref_g.numpy(), rtol=2e-4,
                               atol=2e-4)
    full = torch.autograd.functional.hessian(cond_sum, beta).numpy()
    H = _unpack(h.numpy(), p)
    for c in range(C):
        for gi in range(G):
            np.testing.assert_allclose(-full[c, gi, :, c, gi, :], H[c, gi],
                                       rtol=3e-3, atol=3e-3)
