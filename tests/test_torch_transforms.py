"""The port's bijectors (nestmc_torch/transforms.py) against
nestmc.transforms.

forward and log_jac on x in [-30, 30], inverse on y inside each support
(logit: [1e-6, 1 - 1e-6]; log and softplus: [1e-3, 30]), on the same
float32 inputs: rtol 1e-5, atol 1e-6. log_jac against log |dy/dx| from
torch.autograd in float64 (atol 1e-6; 2e-3 for logit, whose derivative
sigmoid (1 - sigmoid) loses digits to the cancellation 1 - sigmoid(x) at
x near 30 even in float64). The softplus inverse log(-expm1(-y)) + y at
the ends of its range against the float64 value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestmc import transforms as jtr
from nestmc_torch import transforms as tr

NAMES = ("identity", "log", "logit", "softplus")
X = np.linspace(-30.0, 30.0, 601).astype(np.float32)
Y = {
    "identity": np.linspace(-30.0, 30.0, 601),
    "log": np.geomspace(1e-3, 30.0, 601),
    "logit": np.concatenate([np.geomspace(1e-6, 0.5, 300),
                             1.0 - np.geomspace(0.5, 1e-6, 301)]),
    "softplus": np.geomspace(1e-3, 30.0, 601),
}
TOL = dict(rtol=1e-5, atol=1e-6)


def test_registry_matches_reference():
    assert set(tr.TRANSFORMS) == set(jtr.TRANSFORMS)
    for name in NAMES:
        assert tr.get(name).name == name
    with pytest.raises(KeyError):
        tr.get("nope")


@pytest.mark.parametrize("fn", ["forward", "inverse", "log_jac"])
@pytest.mark.parametrize("name", NAMES)
def test_matches_reference(name, fn):
    a = (Y[name] if fn == "inverse" else X).astype(np.float32)
    if name == "logit" and fn == "inverse":
        # 1 - 1e-6 rounds in float32; keep the points below 1
        a = a[a < 1.0]
    ours = getattr(tr.get(name), fn)(torch.from_numpy(a))
    ref = np.asarray(getattr(jtr.get(name), fn)(jnp.asarray(a)))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert np.all(np.isfinite(ours.numpy()))
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_log_jac_is_autograd_derivative(name):
    t = tr.get(name)
    x = torch.from_numpy(X.astype(np.float64)).requires_grad_(True)
    (g,) = torch.autograd.grad(t.forward(x).sum(), x)
    atol = 2e-3 if name == "logit" else 1e-6
    np.testing.assert_allclose(t.log_jac(x.detach()).numpy(),
                               torch.log(g.abs()).numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("y", [1e-3, 1e-2, 0.5, 1.0, 2.0, 30.0])
def test_softplus_inverse_at_the_ends(y):
    """float32 log(-expm1(-y)) + y against float64 log(expm1(y)): the
    relative error stays near float32 rounding at y = 1e-3 and y = 30."""
    got = float(tr.softplus_transform.inverse(
        torch.tensor(y, dtype=torch.float32)))
    exact = float(np.log(np.expm1(np.float64(np.float32(y)))))
    assert got == pytest.approx(exact, rel=2e-6, abs=1e-6)
    back = float(tr.softplus_transform.forward(torch.tensor(got)))
    assert back == pytest.approx(float(np.float32(y)), rel=2e-6)
