"""The likelihood families of the port: the six of the serving model.

The other ten families of the JAX package wait for ROADMAP.md section 1,
item 11.
"""

from hetmogp_tpu_torch.likelihoods.base import Likelihood, safe_exp, safe_square
from hetmogp_tpu_torch.likelihoods.bernoulli import Bernoulli
from hetmogp_tpu_torch.likelihoods.categorical import Categorical
from hetmogp_tpu_torch.likelihoods.exponential import Exponential
from hetmogp_tpu_torch.likelihoods.gamma import Gamma
from hetmogp_tpu_torch.likelihoods.hetgaussian import HetGaussian
from hetmogp_tpu_torch.likelihoods.poisson import Poisson

__all__ = [
    "Likelihood",
    "safe_exp",
    "safe_square",
    "HetGaussian",
    "Bernoulli",
    "Categorical",
    "Poisson",
    "Gamma",
    "Exponential",
]
