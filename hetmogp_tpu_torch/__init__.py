"""hetmogp_tpu_torch: the PyTorch and CUDA port of hetmogp_tpu.

The whole user's lifecycle of the JAX package runs here: build an
``SVMOGP``; train it (stochastic VEM or joint SVI with adam, LR schedules
and clipping, climin Adadelta with its lookahead or natural gradients of
both retractions; on the cached inverse or the solve path, whitened or
not, slice or gather minibatches) with the on-device loop
(``svi_fit_on_device`` around ``make_scan_trainer``, captured CUDA graphs
on the card) with periodic npz checkpoints and an exact resume, the host
loops (``make_trainer``; ``svi_fit`` over a ``MinibatchStream``) or batch
VEM by L-BFGS (``vem_algorithm``); save and load the whole model
(``SVMOGP.save``/``load``, ``save_checkpoint``/``load_checkpoint``, in the
JAX package's npz layout); predict (latent u and f with full covariances,
correlated samples, the projected and stochastic predictions, the
observation-space predictive, NLPD, the cached-inverse serving entry);
and export the predictive paths with ``torch.export`` (``export.py``).
The sixteen likelihood families of the JAX package with their trainable
likelihood parameters (theta), coregionalization rank R >= 1 and the
float64 factorization island (``chol_dtype``) are all here, and so are
the meshes of data and latent ranks (``parallel/``).  Five kernels are
written by hand for the H100 and registered as custom operators
(``hetmogp::``), so that exported programs keep them: the RBF
cross-covariance (``csrc/rbf_kernel.cu``), the triangular projection
P = Kfu iLuu^T in float32 (``csrc/tril_proj_kernel.cu``) and in three bf16
tensor-core passes for ``ve_fwd_precision="high"``
(``csrc/tril_proj3_kernel.cu``), and the right product A tril(L) with
``quad_diag``'s row sums fused (``csrc/tril_right_kernel.cu``) and in
three bf16 passes for the VM step's adjoints at ``"high"`` (in
``csrc/tril_proj3_kernel.cu``).  Two more serve the trainer outside the
operators: the ELBO's likelihood term of every task of a step whose
family has a device function (HetGaussian, Bernoulli, Categorical,
Poisson, Gamma and Exponential: each task's var_exp and its masked,
scaled sum in one launch, their gradient in one more,
``csrc/ve_tasks_kernel.cu``), with the one-pass Gauss-Hermite sweep of
each engine for the families outside it (Beta's and Dirichlet's lngamma
sweeps, ``csrc/gh_sweep_kernel.cu``), and the masked adam update of every
leaf in one launch (``csrc/adam_kernel.cu``).  Trained parameters cross
from the JAX
package with ``params_from_jax`` or a checkpoint, and configs with
``ModelConfig.from_dict``.  Entry points put their tensors on the card
unless the caller passes ``device="cpu"``.  Importing the package needs
neither CUDA nor the JAX package; the kernels are built when a CUDA tensor
first reaches one.
"""

from hetmogp_tpu_torch.checkpoint import (load_checkpoint,
                                          load_checkpoint_sharded, peek_meta,
                                          save_checkpoint,
                                          save_checkpoint_sharded)
from hetmogp_tpu_torch.config import ModelConfig, TrainConfig
from hetmogp_tpu_torch.data import MinibatchStream, batch_scales, full_batch
from hetmogp_tpu_torch.likelihoods import (Bernoulli, Beta, Binomial,
                                           Categorical, Dirichlet,
                                           Exponential, Gamma, Gaussian,
                                           HetGaussian, HetLikelihood,
                                           Likelihood, LogNormal,
                                           NegativeBinomial, Ordinal, Poisson,
                                           StudentT, Weibull,
                                           ZeroInflatedPoisson)
from hetmogp_tpu_torch.metrics import MetricsLogger
from hetmogp_tpu_torch.models.elbo import TaskData, build_elbo, elbo_fn
from hetmogp_tpu_torch.models.params import (SVMOGPParams, default_lik_theta,
                                             init_params, params_from_jax)
from hetmogp_tpu_torch.models.predict import (make_serving_predictive,
                                              negative_log_predictive,
                                              predict_f, predict_f_all,
                                              predict_f_projected,
                                              predict_f_projected_task,
                                              predict_f_stochastic,
                                              predict_latent_u, predictive,
                                              sample_f)
from hetmogp_tpu_torch.models.svmogp import SVMOGP
from hetmogp_tpu_torch.train import (TrainState, init_train_state,
                                     make_dataset, make_scan_trainer,
                                     make_trainer, plot_callback,
                                     prepare_dataset_on_device,
                                     print_callback, svi_fit,
                                     svi_fit_on_device, vem_algorithm)

__all__ = [
    "ModelConfig",
    "TrainConfig",
    "Likelihood",
    "Gaussian",
    "HetGaussian",
    "Bernoulli",
    "Binomial",
    "Categorical",
    "Beta",
    "Gamma",
    "Exponential",
    "LogNormal",
    "NegativeBinomial",
    "Poisson",
    "StudentT",
    "Ordinal",
    "Dirichlet",
    "Weibull",
    "ZeroInflatedPoisson",
    "HetLikelihood",
    "SVMOGP",
    "SVMOGPParams",
    "init_params",
    "default_lik_theta",
    "params_from_jax",
    "TaskData",
    "elbo_fn",
    "build_elbo",
    "TrainState",
    "init_train_state",
    "make_dataset",
    "make_trainer",
    "make_scan_trainer",
    "svi_fit",
    "svi_fit_on_device",
    "vem_algorithm",
    "print_callback",
    "plot_callback",
    "prepare_dataset_on_device",
    "save_checkpoint",
    "load_checkpoint",
    "save_checkpoint_sharded",
    "load_checkpoint_sharded",
    "peek_meta",
    "full_batch",
    "MinibatchStream",
    "batch_scales",
    "MetricsLogger",
    "make_serving_predictive",
    "predict_latent_u",
    "predict_f",
    "predict_f_all",
    "sample_f",
    "predict_f_projected",
    "predict_f_projected_task",
    "predict_f_stochastic",
    "predictive",
    "negative_log_predictive",
]
