"""The sixteen likelihood families, in plain PyTorch, for the reference.

A frozen copy of the measured program's plain mathematics: each family's
variational expectation E_q[log p(y | f)] (a closed form where the program
states one, else Gauss-Hermite on the program's grid sizes), its
observation-space predictive moments, and a sampler for generating data.
A family is built from a configuration's entry, ``{"family": name,
"args": {...}}``, with the program's constructor arguments.

Nothing here imports the measured program.
"""

from __future__ import annotations

import math

import torch

from hmbench.reference.engine import expect, predictive as gh_predictive

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
T1, TM = 20, 10  # nodes per dimension: 1-D sweeps, multi-latent grids


def safe_exp(x):
    return torch.exp(torch.clamp(x, max=math.log(torch.finfo(x.dtype).max) - 1.0))


def safe_square(x):
    lim = torch.finfo(x.dtype).max ** 0.5 / 2.0
    return torch.square(torch.clamp(x, -lim, lim))


def logaddexp(a, b):
    return torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))


def log_probs(f):
    """(log p, log(1 - p)) of the logistic link, clipped to [1e-9, 1-1e-9]
    in log space."""
    z = torch.zeros_like(f)
    lo, hi = math.log(1e-9), math.log1p(-1e-9)
    return (torch.clamp(-logaddexp(-f, z), lo, hi),
            torch.clamp(-logaddexp(f, z), lo, hi))


def prob(f):
    ef = safe_exp(f)
    return torch.clamp(ef / (1.0 + ef), 1e-9, 1.0 - 1e-9)


def clip_exp(x):
    return torch.clamp(safe_exp(x), 1e-9, 1e9)


def _lngamma_of_exp(F, Y, th):
    return torch.lgamma(clip_exp(F[..., 0]))


def e_lngamma(m, v):
    """E[ln Gamma(clip(e^f))] per row of (N, 1) moments on the 1-D grid."""
    return expect(_lngamma_of_exp, m, m, v, T1)


def _uniform(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype, device=like.device)


def _labels(gen, p):
    """1-based class labels drawn from the rows of p (N, K), (N, 1)."""
    u = _uniform(gen, p[:, :1].shape, p)
    return 1.0 + torch.sum(u > torch.cumsum(p, dim=1)[:, :-1], dim=1,
                           keepdim=True).to(p.dtype)


def _gamma(gen, a):
    return torch._standard_gamma(a, generator=gen)


class Family:
    dim_y = dim_f = dim_p = 1
    n_theta = 0
    T = T1  # nodes per dimension of the Gauss-Hermite var_exp

    def theta0(self):
        return []

    def logpdf(self, F, Y, th=None):
        raise NotImplementedError

    def var_exp(self, Y, M, V, theta=None):
        return expect(self.logpdf, Y, M, V, self.T, theta if self.n_theta else None)


class HetGaussian(Family):
    dim_f = 2

    def var_exp(self, Y, M, V, theta=None):
        y, m1, m2, v1, v2 = Y[:, 0], M[:, 0], M[:, 1], V[:, 0], V[:, 1]
        prec = torch.clamp(safe_exp(-m2 + 0.5 * v2), -1e9, 1e9)
        sq = torch.clamp(safe_square(y) + safe_square(m1) + v1 - 2.0 * m1 * y,
                         -1e9, 1e9)
        return -HALF_LOG_2PI - 0.5 * m2 - 0.5 * prec * sq

    def predictive(self, M, V):
        Evar = torch.clamp(safe_exp(M[:, 1:] + 0.5 * V[:, 1:]), 0.0, 1e9)
        return M[:, :1], Evar + V[:, :1]


class Bernoulli(Family):

    def logpdf(self, F, Y, th=None):
        lp, l1p = log_probs(F[..., 0])
        return Y[..., 0] * lp + (1.0 - Y[..., 0]) * l1p

    def predictive(self, M, V):
        def cm(F):
            p = prob(F[..., :1])
            return p, p * (1.0 - p)
        return gh_predictive(cm, M, V, T1)


class Categorical(Family):
    T = TM

    def __init__(self, K=3):
        self.K = K
        self.dim_f = self.dim_p = K - 1

    def _p(self, F):
        ef = safe_exp(F)
        den = 1.0 + torch.sum(ef, dim=-1, keepdim=True)
        p = torch.clamp(torch.cat([ef / den, 1.0 / den], dim=-1), 1e-9, 1 - 1e-9)
        return p / torch.sum(p, dim=-1, keepdim=True)

    def logpdf(self, F, Y, th=None):
        classes = torch.arange(1, self.K + 1, dtype=Y.dtype, device=Y.device)
        return torch.sum((classes == Y).to(F.dtype) * torch.log(self._p(F)), -1)

    def predictive(self, M, V):
        def cm(F):
            # the stated conditional mean: the K - 1 probabilities,
            # clipped and renormalized among themselves
            ef = safe_exp(F)
            rho = torch.clamp(ef / (1.0 + torch.sum(ef, -1, keepdim=True)), 1e-9, 1 - 1e-9)
            rho = rho / torch.sum(rho, -1, keepdim=True)
            return rho, rho * (1.0 - rho)
        mean, _ = gh_predictive(cm, M, V, TM)
        return mean, torch.zeros_like(mean)  # the stated variance is none


class Poisson(Family):

    def var_exp(self, Y, M, V, theta=None):
        y, m, v = Y[:, 0], M[:, 0], V[:, 0]
        return y * m - safe_exp(m + 0.5 * v) - torch.lgamma(y + 1.0)

    def predictive(self, M, V):
        Em = torch.clamp(safe_exp(M + 0.5 * V), 0.0, 1e9)
        Em2 = torch.clamp(safe_exp(2.0 * M + 2.0 * V), 0.0, 1e18)
        return Em, Em + Em2 - torch.square(Em)


class Gamma(Family):
    dim_f = 2

    def var_exp(self, Y, M, V, theta=None):
        y = Y[:, 0]
        Ea = clip_exp(M[:, 0] + 0.5 * V[:, 0])
        Eb = clip_exp(M[:, 1] + 0.5 * V[:, 1])
        return (-e_lngamma(M[:, :1], V[:, :1]) + Ea * M[:, 1]
                + (Ea - 1.0) * torch.log(y) - Eb * y)

    def predictive(self, M, V):
        m1, v1, m2, v2 = M[:, :1], V[:, :1], M[:, 1:], V[:, 1:]
        Ea = clip_exp(m1 + 0.5 * v1)
        Ea2 = torch.clamp(safe_exp(2.0 * m1 + 2.0 * v1), 1e-18, 1e18)
        Eib = clip_exp(-m2 + 0.5 * v2)
        Eib2 = torch.clamp(safe_exp(-2.0 * m2 + 2.0 * v2), 1e-18, 1e18)
        mean = Ea * Eib
        return mean, (Ea + Ea2) * Eib2 - torch.square(mean)


class Exponential(Family):

    def var_exp(self, Y, M, V, theta=None):
        return M[:, 0] - Y[:, 0] * clip_exp(M[:, 0] + 0.5 * V[:, 0])

    def predictive(self, M, V):
        Eb = clip_exp(-M + 0.5 * V)
        Eb2 = torch.clamp(safe_exp(-2.0 * M + 2.0 * V), 1e-18, 1e18)
        return Eb, 2.0 * Eb2 - torch.square(Eb)


class Gaussian(Family):
    def __init__(self, sigma=0.5, learn_sigma=False):
        self.sigma, self.n_theta = sigma, int(bool(learn_sigma))

    def theta0(self):
        return [math.log(self.sigma)] if self.n_theta else []

    def var_exp(self, Y, M, V, theta=None):
        if self.n_theta:
            s2 = torch.exp(2.0 * theta[0])
            log_s2 = torch.log(s2)
        else:
            s2 = self.sigma ** 2
            log_s2 = math.log(s2)
        y, m, v = Y[:, 0], M[:, 0], V[:, 0]
        return (-HALF_LOG_2PI - 0.5 * log_s2
                - 0.5 * (torch.square(y) + torch.square(m) + v - 2.0 * m * y) / s2)

    def sample(self, gen, F):
        return F[:, :1] + self.sigma * torch.randn(
            F[:, :1].shape, generator=gen, dtype=F.dtype, device=F.device)


def _lgamma_ab(F, Y, th):
    return torch.lgamma(clip_exp(F[..., 0]) + clip_exp(F[..., 1]))


class Beta(Family):
    dim_f = 2

    def var_exp(self, Y, M, V, theta=None):
        y = Y[:, 0]
        Ea = clip_exp(M[:, 0] + 0.5 * V[:, 0])
        Eb = clip_exp(M[:, 1] + 0.5 * V[:, 1])
        return ((Ea - 1.0) * torch.log(y) + (Eb - 1.0) * torch.log1p(-y)
                - e_lngamma(M[:, :1], V[:, :1]) - e_lngamma(M[:, 1:], V[:, 1:])
                + expect(_lgamma_ab, Y, M, V, TM))

    def sample(self, gen, F):
        ga, gb = _gamma(gen, clip_exp(F[:, :1])), _gamma(gen, clip_exp(F[:, 1:2]))
        return ga / (ga + gb)


class Binomial(Family):
    def __init__(self, n=1):
        self.n = int(n)

    def logpdf(self, F, Y, th=None):
        lp, l1p = log_probs(F[..., 0])
        n, y = float(self.n), Y[..., 0]
        return (math.lgamma(n + 1.0) - torch.lgamma(y + 1.0)
                - torch.lgamma(n - y + 1.0) + y * lp + (n - y) * l1p)

    def sample(self, gen, F):
        p = prob(F[:, :1])
        u = _uniform(gen, (F.shape[0], self.n), F)
        return torch.sum(u < p, dim=1, keepdim=True).to(F.dtype)


def _lgamma_sum(F, Y, th):
    return torch.lgamma(torch.sum(clip_exp(F), dim=-1))


class Dirichlet(Family):
    def __init__(self, K=3):
        self.K = K
        self.dim_y = self.dim_f = self.dim_p = K
        self.T = TM if K <= 2 else 5

    def var_exp(self, Y, M, V, theta=None):
        n = M.shape[0]
        Ea = clip_exp(M + 0.5 * V)
        E_lga = e_lngamma(M.reshape(-1, 1), V.reshape(-1, 1)).reshape(n, self.K)
        return (expect(_lgamma_sum, Y, M, V, self.T) - torch.sum(E_lga, dim=1)
                + torch.sum((Ea - 1.0) * torch.log(Y), dim=1))

    def sample(self, gen, F):
        g = _gamma(gen, clip_exp(F))
        return g / torch.sum(g, dim=1, keepdim=True)


class LogNormal(Family):
    def __init__(self, sigma=0.5, learn_sigma=False):
        self.sigma, self.n_theta = sigma, int(bool(learn_sigma))

    def theta0(self):
        return [math.log(self.sigma)] if self.n_theta else []

    def var_exp(self, Y, M, V, theta=None):
        if self.n_theta:
            s2 = torch.exp(2.0 * theta[0])
            log_s2 = torch.log(s2)
        else:
            s2 = self.sigma ** 2
            log_s2 = math.log(s2)
        ly = torch.log(torch.clamp(Y[:, 0], min=1e-30))
        return (-ly - 0.5 * log_s2 - HALF_LOG_2PI
                - 0.5 * (torch.square(ly - M[:, 0]) + V[:, 0]) / s2)

    def sample(self, gen, F):
        z = torch.randn(F[:, :1].shape, generator=gen, dtype=F.dtype,
                        device=F.device)
        return safe_exp(F[:, :1] + self.sigma * z)


class Ordinal(Family):
    def __init__(self, K=3, thresholds=None):
        self.K, self.n_theta, self.dim_p = K, K - 1, K
        self.b = (list(thresholds) if thresholds is not None else
                  [-(K - 2) / 2.0 + i * (K - 2) / max(K - 2, 1)
                   for i in range(K - 1)] if K > 2 else [0.0])

    def theta0(self):
        return [self.b[0]] + [math.log(self.b[i + 1] - self.b[i])
                              for i in range(self.K - 2)]

    def _probs(self, F, b):
        cdf = torch.sigmoid(b - F[..., :1])
        p = torch.diff(cdf, dim=-1, prepend=torch.zeros_like(cdf[..., :1]),
                       append=torch.ones_like(cdf[..., :1]))
        return torch.clamp(p, 1e-9, 1.0)

    def logpdf(self, F, Y, th=None):
        b = torch.cumsum(torch.cat([th[..., :1], torch.exp(th[..., 1:])], -1), -1)
        classes = torch.arange(1, self.K + 1, dtype=Y.dtype, device=Y.device)
        return torch.sum((classes == Y).to(F.dtype)
                         * torch.log(self._probs(F, b.to(F.dtype))), dim=-1)

    def sample(self, gen, F):
        b = torch.tensor(self.b, dtype=F.dtype, device=F.device)
        return _labels(gen, self._probs(F, b))


class NegativeBinomial(Family):
    def __init__(self, r=2.0, learn_r=False):
        self.r, self.n_theta = r, int(bool(learn_r))

    def theta0(self):
        return [math.log(self.r)] if self.n_theta else []

    def logpdf(self, F, Y, th=None):
        r = torch.exp(th[..., 0]) if th is not None else self.r
        mu = clip_exp(F[..., 0])
        y = Y[..., 0]
        lg = torch.lgamma(r) if torch.is_tensor(r) else math.lgamma(r)
        lr = torch.log(r) if torch.is_tensor(r) else math.log(r)
        log_rmu = torch.log(r + mu)
        return (torch.lgamma(y + r) - lg - torch.lgamma(y + 1.0)
                + r * (lr - log_rmu) + y * (torch.log(mu) - log_rmu))

    def sample(self, gen, F):
        mu = clip_exp(F[:, :1])
        lam = _gamma(gen, torch.full_like(mu, self.r)) * (mu / self.r)
        return torch.poisson(lam, generator=gen)


class StudentT(Family):
    dim_f = 2

    def __init__(self, df=4.0, learn_df=False):
        self.df, self.n_theta = df, int(bool(learn_df))

    def theta0(self):
        return [math.log(self.df)] if self.n_theta else []

    def logpdf(self, F, Y, th=None):
        v = torch.exp(th[..., 0]) if th is not None else self.df
        scale = clip_exp(F[..., 1])
        r = (Y[..., 0] - F[..., 0]) / scale
        lg = torch.lgamma if torch.is_tensor(v) else math.lgamma
        lo = torch.log if torch.is_tensor(v) else math.log
        return (lg((v + 1.0) / 2.0) - lg(v / 2.0) - 0.5 * lo(v * math.pi)
                - torch.log(scale) - (v + 1.0) / 2.0 * torch.log1p(torch.square(r) / v))

    def sample(self, gen, F):
        z = torch.randn(F[:, :1].shape, generator=gen, dtype=F.dtype, device=F.device)
        g = _gamma(gen, torch.full_like(z, 0.5 * self.df))
        return F[:, :1] + safe_exp(F[:, 1:2]) * z / torch.sqrt(2.0 * g / self.df)


class Weibull(Family):
    def __init__(self, k=1.5, learn_k=False):
        self.k, self.n_theta = k, int(bool(learn_k))

    def theta0(self):
        return [math.log(self.k)] if self.n_theta else []

    def var_exp(self, Y, M, V, theta=None):
        k = torch.exp(theta[0]) if self.n_theta else self.k
        log_y = torch.log(torch.clamp(Y[:, 0], min=1e-30))
        m, v = M[:, 0], V[:, 0]
        log_scale = torch.clamp(m + 0.5 * k * v, math.log(1e-9), math.log(1e9))
        log_k = torch.log(k) if torch.is_tensor(k) else math.log(k)
        return log_k + k * m + (k - 1.0) * log_y - safe_exp(k * (log_y + log_scale))

    def sample(self, gen, F):
        b = clip_exp(-F[:, :1])
        e = -torch.log1p(-_uniform(gen, b.shape, b))
        return b * torch.pow(e, 1.0 / self.k)


class ZeroInflatedPoisson(Family):
    dim_f = 2
    T = TM

    def logpdf(self, F, Y, th=None):
        f1, y = F[..., 0], Y[..., 0]
        lam = clip_exp(f1)
        lpi, l1pi = log_probs(F[..., 1])
        pois = y * f1 - lam - torch.lgamma(y + 1.0)
        return torch.where(y == 0, logaddexp(lpi, l1pi - lam), l1pi + pois)

    def sample(self, gen, F):
        lam, pi = clip_exp(F[:, :1]), prob(F[:, 1:2])
        on = (_uniform(gen, pi.shape, pi) >= pi).to(F.dtype)
        return on * torch.poisson(lam, generator=gen)


FAMILIES = {c.__name__: c for c in (
    HetGaussian, Bernoulli, Categorical, Poisson, Gamma, Exponential, Gaussian,
    Beta, Binomial, Dirichlet, LogNormal, Ordinal, NegativeBinomial, StudentT,
    Weibull, ZeroInflatedPoisson)}


def build(entry: dict) -> Family:
    """The family of a configuration entry {"family": name, "args": {...}}."""
    return FAMILIES[entry["family"]](**entry.get("args", {}))
