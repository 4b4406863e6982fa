"""nestmc_torch: the PyTorch + CUDA port of nestmc for one NVIDIA H100.

The JAX package ``nestmc`` is the reference; this package mirrors its
module tree. So far it runs the hierarchical logistic model (Newton-MH,
MALA and RW-MH group updates, both tau priors, the joint (mu, log tau)
interweaving move) on padded and on ragged data (per size bucket through
the padded kernels, or through the segment kernels), and the three-level
nested Poisson GLMM (the same three subject updates, conjugate beta_g / mu
/ tau draws, the tau_g and tau_s interweaving moves), with the obs passes
and the fused steps as hand-written CUDA kernels (``csrc/``). Tensors on a CUDA
device launch the kernels; tensors on the CPU run their plain PyTorch
versions. It imports torch and numpy, never jax.
"""

from nestmc_torch.config import (
    KernelConfig,
    RunConfig,
    SamplerConfig,
    ShardingConfig,
)
from nestmc_torch.data import (
    NestedData,
    NestedData3,
    RaggedData,
    from_numpy,
    from_numpy3,
    from_numpy_ragged,
)
from nestmc_torch.engine import sample
from nestmc_torch.model import Block, ModelSpec
from nestmc_torch.posterior import Posterior
from nestmc_torch.rng import SweepRNG

__version__ = "0.1.0"

__all__ = [
    "Block",
    "KernelConfig",
    "ModelSpec",
    "NestedData",
    "NestedData3",
    "Posterior",
    "RaggedData",
    "RunConfig",
    "SamplerConfig",
    "ShardingConfig",
    "SweepRNG",
    "from_numpy",
    "from_numpy3",
    "from_numpy_ragged",
    "sample",
    "__version__",
]
