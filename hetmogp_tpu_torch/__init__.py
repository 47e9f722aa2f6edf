"""hetmogp_tpu_torch: the PyTorch and CUDA port of hetmogp_tpu.

So far the port serves: the observation-space predictive of a trained
heterogeneous multi-output GP, with the RBF cross-covariance as a
hand-written CUDA kernel for the H100 (``csrc/rbf_kernel.cu``).  Trained
parameters cross from the JAX package with ``params_from_jax`` and
``ModelConfig.from_dict``.  Importing the package needs neither CUDA nor
the JAX package; the kernel is built when a CUDA tensor first reaches it.
"""

from hetmogp_tpu_torch.config import ModelConfig
from hetmogp_tpu_torch.likelihoods import (Bernoulli, Categorical, Exponential,
                                           Gamma, HetGaussian, Likelihood,
                                           Poisson)
from hetmogp_tpu_torch.models.params import (SVMOGPParams, init_params,
                                             params_from_jax)
from hetmogp_tpu_torch.models.predict import (make_serving_predictive,
                                              predict_f, predict_f_all,
                                              predictive)

__all__ = [
    "ModelConfig",
    "Likelihood",
    "HetGaussian",
    "Bernoulli",
    "Categorical",
    "Poisson",
    "Gamma",
    "Exponential",
    "SVMOGPParams",
    "init_params",
    "params_from_jax",
    "make_serving_predictive",
    "predict_f",
    "predict_f_all",
    "predictive",
]
