"""nestmc_torch: the PyTorch + CUDA port of nestmc for one NVIDIA H100.

The JAX package ``nestmc`` is the reference; this package mirrors its
module tree. So far it runs the judged path: the hierarchical logistic
model with Newton-MH group updates, exact conjugate mu / log tau draws and
the joint (mu, log tau) interweaving move, with the obs passes and the
Newton step as hand-written CUDA kernels (``csrc/``). Tensors on a CUDA
device launch the kernels; tensors on the CPU run their plain PyTorch
versions. It imports torch and numpy, never jax.
"""

from nestmc_torch.config import (
    KernelConfig,
    RunConfig,
    SamplerConfig,
    ShardingConfig,
)
from nestmc_torch.data import NestedData, from_numpy
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
    "Posterior",
    "RunConfig",
    "SamplerConfig",
    "ShardingConfig",
    "SweepRNG",
    "from_numpy",
    "sample",
    "__version__",
]
