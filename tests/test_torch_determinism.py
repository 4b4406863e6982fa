"""Same seed => bitwise-identical draws (twin of the unsharded half of
tests/test_determinism.py: G=16, n=12, p=2, 16 chains, 60/60, seeds 9 and
10). The port's noise comes from the run's SweepRNG alone (no global
RNG), and its reductions have a fixed order, so a second run at the same
seed repeats every bit; another seed moves mu. The sharded pair waits for
the port's sharding. Run here on the CPU (plain versions of the kernels,
the reference's RW-MH default) and, for the fused steps' plain versions,
with Newton-MH and MALA; chip_smoke.py phase 9c holds the kernels on the
card to the same.
"""

import numpy as np
import pytest

from nestmc_torch import KernelConfig, RunConfig, SamplerConfig, sample
from nestmc_torch.models import make_hier_logistic, synth_logistic
from tests.test_torch_calibration import one_thread  # noqa: F401


def _run(seed=9, algorithm="rwmh"):
    data, _ = synth_logistic(21, G=16, n=12, p=2, device="cpu")
    model = make_hier_logistic(data)
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm=algorithm),
        run=RunConfig(chains=16, warmup=60, draws=60, seed=seed,
                      log_every_segment=False),
    )
    return sample(model, data, cfg)


@pytest.mark.parametrize("algorithm", ["rwmh", "mala", "newton"])
def test_same_seed_bitwise_identical(algorithm):
    a = _run(algorithm=algorithm)
    b = _run(algorithm=algorithm)
    assert set(a.draws) == set(b.draws)
    for k in a.draws:
        np.testing.assert_array_equal(a.draws[k].numpy(), b.draws[k].numpy(),
                                      err_msg=k)


def test_different_seed_differs():
    a = _run(seed=9)
    b = _run(seed=10)
    assert not np.array_equal(a.draws["mu"].numpy(), b.draws["mu"].numpy())
