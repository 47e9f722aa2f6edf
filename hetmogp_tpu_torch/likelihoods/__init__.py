"""The likelihood families of the port: the JAX package's sixteen, and the
``HetLikelihood`` dispatcher."""

from hetmogp_tpu_torch.likelihoods.base import Likelihood, safe_exp, safe_square
from hetmogp_tpu_torch.likelihoods.bernoulli import Bernoulli
from hetmogp_tpu_torch.likelihoods.beta import Beta
from hetmogp_tpu_torch.likelihoods.binomial import Binomial
from hetmogp_tpu_torch.likelihoods.categorical import Categorical
from hetmogp_tpu_torch.likelihoods.dirichlet import Dirichlet
from hetmogp_tpu_torch.likelihoods.exponential import Exponential
from hetmogp_tpu_torch.likelihoods.gamma import Gamma
from hetmogp_tpu_torch.likelihoods.gaussian import Gaussian
from hetmogp_tpu_torch.likelihoods.hetgaussian import HetGaussian
from hetmogp_tpu_torch.likelihoods.heterogeneous import HetLikelihood
from hetmogp_tpu_torch.likelihoods.lognormal import LogNormal
from hetmogp_tpu_torch.likelihoods.negbinomial import NegativeBinomial
from hetmogp_tpu_torch.likelihoods.ordinal import Ordinal
from hetmogp_tpu_torch.likelihoods.poisson import Poisson
from hetmogp_tpu_torch.likelihoods.student import StudentT
from hetmogp_tpu_torch.likelihoods.weibull import Weibull
from hetmogp_tpu_torch.likelihoods.zipoisson import ZeroInflatedPoisson

__all__ = [
    "Likelihood",
    "safe_exp",
    "safe_square",
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
]
