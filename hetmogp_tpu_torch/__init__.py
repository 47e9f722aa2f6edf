"""hetmogp_tpu_torch: the PyTorch and CUDA port of hetmogp_tpu.

The port serves and trains: the observation-space predictive of a trained
heterogeneous multi-output GP, and the flagship stochastic VEM trainer
(adam, the cached fast projection, slice minibatches).  Two kernels are
written by hand for the H100: the RBF cross-covariance
(``csrc/rbf_kernel.cu``) and the triangular projection P = Kfu iLuu^T
(``csrc/tril_proj_kernel.cu``).  Trained parameters cross from the JAX
package with ``params_from_jax`` and ``ModelConfig.from_dict``.  Importing
the package needs neither CUDA nor the JAX package; the kernels are built
when a CUDA tensor first reaches one.
"""

from hetmogp_tpu_torch.config import ModelConfig, TrainConfig
from hetmogp_tpu_torch.likelihoods import (Bernoulli, Categorical, Exponential,
                                           Gamma, HetGaussian, Likelihood,
                                           Poisson)
from hetmogp_tpu_torch.models.elbo import TaskData, elbo_fn
from hetmogp_tpu_torch.models.params import (SVMOGPParams, init_params,
                                             params_from_jax)
from hetmogp_tpu_torch.models.predict import (make_serving_predictive,
                                              predict_f, predict_f_all,
                                              predictive)
from hetmogp_tpu_torch.train import (TrainState, init_train_state,
                                     make_dataset, make_trainer)

__all__ = [
    "ModelConfig",
    "TrainConfig",
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
    "TaskData",
    "elbo_fn",
    "TrainState",
    "init_train_state",
    "make_dataset",
    "make_trainer",
    "make_serving_predictive",
    "predict_f",
    "predict_f_all",
    "predictive",
]
