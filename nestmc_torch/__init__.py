"""nestmc_torch: the PyTorch + CUDA port of nestmc for one NVIDIA H100.

The JAX package ``nestmc`` is the reference; this package mirrors its
module tree. So far it runs the hierarchical logistic model (Newton-MH,
MALA and RW-MH group updates, both tau priors, the joint (mu, log tau)
interweaving move) on padded and on ragged data (per size bucket through
the padded kernels, or through the segment kernels), the three-level
nested Poisson GLMM (the same three subject updates, conjugate beta_g / mu
/ tau draws, the tau_g and tau_s interweaving moves) and the generic
hierarchical GLM of five response families (models/hier_glm.py: binomial
and bernoulli on the logistic kernels, poisson on the Poisson ones,
gaussian and negbin in plain PyTorch), with the obs passes
and the fused steps as hand-written CUDA kernels (``csrc/``). Tensors on a CUDA
device launch the kernels; tensors on the CPU run their plain PyTorch
versions. It imports torch and numpy, never jax. Its command line,
``python -m nestmc_torch run | compare | list-presets`` (cli.py), runs a
preset on the card, checkpoints and resumes it (checkpoint.py), and ranks
saved runs by WAIC or PSIS-LOO (compare.py). Posterior-predictive checks
(predictive.py) and a CSV loader with a native parser (io/) complete the
user path: load, fit, check, compare. A user's own model, written for one
chain with distributions.py and transforms.py, is lifted to the chains
by model.vmap_chains; data.py builds data from per-group lists
(``from_ragged``). parallel/ shards a run over processes on
torch.distributed, one device each: chains (the unsharded draws, bitwise)
and groups (the sums over groups all-reduced).
"""

from nestmc_torch.compare import compare, psis_loo, waic
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
from nestmc_torch.predictive import posterior_predictive, predictive_pvalue
from nestmc_torch.rng import SweepRNG

__version__ = "0.1.0"

__all__ = [
    "Block",
    "KernelConfig",
    "compare",
    "psis_loo",
    "waic",
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
    "posterior_predictive",
    "predictive_pvalue",
    "sample",
    "__version__",
]
