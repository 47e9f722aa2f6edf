"""The plain reference of the sparse variational heterogeneous multi-output
GP: the whitened LMC model's moments, ELBO, gradients, the adam steps of
the VE/VM schedule, and the served predictive moments.

Straightforward PyTorch: the RBF Gram by explicit differences, the
Cholesky factor and its inverse by the library's dense routines, every
product a dense matmul, gradients by autograd (the likelihood terms by the
Bonnet/Price forms of ``engine``), no cache, no kernels and no batching
tricks.  ``precision="float64"`` is the judge; ``precision="tf32"`` is the
control: float32 with every product's operands rounded to TF32 (10
mantissa bits), as the card's tensor cores round them.

It takes the inputs and the initial parameters that the harness made from
the seed and works out everything else again (Kuu, Luu, its inverse, the
projections, the moments).  Nothing here imports the measured program.
"""

from __future__ import annotations

import math

import torch

from hmbench.reference import families

B1, B2, EPS = 0.9, 0.999, 1e-8  # adam's constants as the configuration states
LEAVES = ("Z", "q_mu", "q_sqrt", "log_lengthscale", "log_variance", "W", "kappa")
VE_FREE = ("q_mu", "q_sqrt")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest, ties to even, at 10 mantissa bits."""
    i = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = (i + 0xFFF + ((i >> 13) & 1)) & 0xFFFFE000
    i = torch.where(i >= 2 ** 31, i - 2 ** 32, i)
    return i.to(torch.int32).view(torch.float32)


class _MmTF32(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).mT, tf32_round(a).mT @ g


class Reference:
    """One configuration's reference at one precision on one device."""

    def __init__(self, config: dict, device, precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.cfg, self.device, self.precision = config, device, precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.liks = [families.build(e) for e in config["likelihoods"]]
        self.Q, self.M = config["num_latent"], config["num_inducing"]
        self.jitter = config["jitter"]
        starts = [0]
        for lik in self.liks:
            starts.append(starts[-1] + lik.dim_f)
        self.fslices = list(zip(starts[:-1], starts[1:]))

    # ---- products --------------------------------------------------------
    def mm(self, a, b):
        if self.precision == "tf32":
            return _MmTF32.apply(a, b)
        return a @ b

    def cast(self, params: dict) -> dict:
        out = {k: v.detach().to(self.device, self.dtype) for k, v in params.items()
               if k != "lik_theta"}
        out["lik_theta"] = [t.detach().to(self.device, self.dtype)
                            for t in params.get("lik_theta") or
                            [torch.zeros(0)] * len(self.liks)]
        return out

    # ---- the model ---------------------------------------------------------
    def kern(self, X, Z, ls, var):
        """var exp(-|x - z|^2 / (2 ls^2)): X (N, Dx), Z (Q, M, Dx) -> (Q, N, M)."""
        d = X[None, :, None, :] / ls[:, None, None, :] - Z[:, None] / ls[:, None, None, :]
        return var[:, None, None] * torch.exp(-0.5 * torch.sum(d * d, dim=-1))

    def _gram(self, Z, ls, var):
        S = Z / ls[:, None, :]
        d = S[:, :, None, :] - S[:, None, :, :]
        return var[:, None, None] * torch.exp(-0.5 * torch.sum(d * d, dim=-1))

    def factor(self, p):
        """(Luu, Luu^{-1}) of Kuu + jitter I."""
        ls, var = torch.exp(p["log_lengthscale"]), torch.exp(p["log_variance"])
        Kuu = self._gram(p["Z"], ls, var)
        L = torch.linalg.cholesky(
            Kuu + self.jitter * torch.eye(self.M, dtype=Kuu.dtype, device=Kuu.device))
        eye = torch.eye(self.M, dtype=L.dtype, device=L.device).expand_as(L)
        return L, torch.linalg.solve_triangular(L, eye, upper=False)

    def latent(self, p, X, iL):
        """(mean_q, gamma_q, kdiag), each (Q, N)."""
        ls, var = torch.exp(p["log_lengthscale"]), torch.exp(p["log_variance"])
        Kfu = self.kern(X, p["Z"], ls, var)
        P = self.mm(Kfu, iL.mT)
        mean = self.mm(P, p["q_mu"][..., None])[..., 0]
        PL = self.mm(P, torch.tril(p["q_sqrt"]))
        kdiag = var[:, None].expand(self.Q, X.shape[0])
        gamma = kdiag + torch.sum(PL * PL, -1) - torch.sum(P * P, -1)
        return mean, gamma, kdiag

    def mix(self, p, mean, gamma, kdiag, t):
        s0, s1 = self.fslices[t]
        W, kap = p["W"][:, s0:s1], p["kappa"][:, s0:s1]
        m = self.mm(mean.mT, W)
        v = self.mm(gamma.mT, W * W) + self.mm(kdiag.mT, kap)
        return m, torch.clamp(v, min=0.0)

    def kl(self, p):
        Lq = torch.tril(p["q_sqrt"])
        logdet = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(Lq, dim1=-2, dim2=-1))), -1)
        return torch.sum(0.5 * (torch.sum(Lq * Lq, (-2, -1))
                                + torch.sum(p["q_mu"] ** 2, -1) - self.M - logdet))

    def elbo(self, p, batch, scales):
        """batch: per task (X, Y); scales: per task N_t / B_t."""
        _, iL = self.factor(p)
        X = torch.cat([x for x, _ in batch])
        mean, gamma, kdiag = self.latent(p, X, iL)
        total, off = 0.0, 0
        for t, (lik, (x, y)) in enumerate(zip(self.liks, batch)):
            sl = slice(off, off + x.shape[0])
            off = sl.stop
            m, v = self.mix(p, mean[:, sl], gamma[:, sl], kdiag[:, sl], t)
            theta = p["lik_theta"][t] if lik.n_theta else None
            total = total + scales[t] * torch.sum(lik.var_exp(y, m, v, theta))
        return total - self.kl(p)

    # ---- training ------------------------------------------------------------
    def train_steps(self, params0, steps, free_vm, lr):
        """The adam steps of the schedule from ``params0``.

        steps: per step (kind "ve" or "vm", batch [(X_t, Y_t)], scales).
        free_vm: the leaves a VM step frees.
        Returns (elbos before each update, {leaf: gradient of -ELBO at the
        step where it is first free}, params after the last step)."""
        p = self.cast(params0)
        names = list(LEAVES) + [f"lik_theta.{t}" for t in range(len(self.liks))]

        def get(q, name):
            return q["lik_theta"][int(name.split(".")[1])] if "." in name else q[name]

        def put(q, name, t):
            if "." in name:
                q["lik_theta"][int(name.split(".")[1])] = t
            else:
                q[name] = t

        mu = {n: torch.zeros_like(get(p, n)) for n in names}
        nu = {n: torch.zeros_like(get(p, n)) for n in names}
        elbos, first = [], {}
        for count, (kind, batch, scales) in enumerate(steps, start=1):
            free = [n for n in names if (n.split(".")[0] in
                                         (VE_FREE if kind == "ve" else free_vm))
                    and get(p, n).numel()]
            q = {k: (v.clone() if k != "lik_theta" else list(v)) for k, v in p.items()}
            for n in free:
                put(q, n, get(p, n).clone().requires_grad_())
            with torch.enable_grad():
                e = self.elbo(q, batch, scales)
                grads = dict(zip(free, torch.autograd.grad(-e, [get(q, n) for n in free])))
            elbos.append(float(e.detach()))
            bc1, bc2 = 1.0 - B1 ** count, 1.0 - B2 ** count
            for n in names:
                g = grads.get(n)
                if g is None:
                    mu[n], nu[n] = B1 * mu[n], B2 * nu[n]
                    continue
                first.setdefault(n, g.detach())
                mu[n] = (1.0 - B1) * g + B1 * mu[n]
                nu[n] = (1.0 - B2) * g * g + B2 * nu[n]
                put(p, n, get(p, n) - lr * (mu[n] / bc1)
                    / (torch.sqrt(nu[n] / bc2) + EPS))
            p = {k: (v.detach() if k != "lik_theta" else [t.detach() for t in v])
                 for k, v in p.items()}
        return elbos, first, p

    # ---- serving ---------------------------------------------------------------
    def served(self, params, X, t, block=8192):
        """Task t's predictive (mean, var), each (N, dim_p), at rows X."""
        p = self.cast(params)
        key = id(params)
        if getattr(self, "_factor", (None,))[0] != key:
            self._factor = (key, self.factor(p)[1])
        iL = self._factor[1]
        X = X.to(self.device, self.dtype)
        outs = []
        for r0 in range(0, X.shape[0], block):
            mean, gamma, kdiag = self.latent(p, X[r0:r0 + block], iL)
            m, v = self.mix(p, mean, gamma, kdiag, t)
            outs.append(self.liks[t].predictive(m, v))
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def leaf_norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def leaf_gaps(got: dict, want: dict) -> dict:
    """{leaf: |norm(got) - norm(want)| / max(norm(want), the median leaf's
    norm)} over the leaves whose reference norm is at least a thousandth of
    the median leaf's (a leaf the reference leaves at zero to rounding
    moves by round-off alone)."""
    wn, gn = leaf_norms(want), leaf_norms(got)
    vals = sorted(wn.values())
    med = vals[len(vals) // 2] if vals else 0.0
    return {n: abs(gn.get(n, 0.0) - wn[n]) / max(wn[n], med)
            for n in wn if wn[n] >= 1e-3 * med and wn[n] > 0.0}


def worst(values) -> float:
    """The largest of ``values``; inf where any is not finite."""
    values = list(values)
    if not values or not all(math.isfinite(v) for v in values):
        return math.inf
    return max(values)
