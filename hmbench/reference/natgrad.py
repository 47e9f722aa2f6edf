"""The plain reference of the natural-gradient trainer: exact natural-
parameter steps on the whitened q(u) = N(m, S) and adam on the rest, as
Salimbeni, Eleftheriadis and Hensman (Natural Gradients in Practice,
AISTATS 2018) train a sparse variational GP.

A VE step differentiates ``svgp.Reference``'s ELBO, its moments written in
S (gamma = kdiag + diag(P S P^T) - diag(P P^T)) and its KL in (m, S), with
respect to (m, S) by autograd, and takes one step of rate ``lr`` on the
natural parameters (theta_1, theta_2) = (S^{-1} m, -S^{-1} / 2):

    theta_1' = S^{-1} m + lr (dL/dm - 2 dL/dS m)
    S'^{-1}  = S^{-1} - 2 lr dL/dS + jitter I
    L' = cholesky(inv(S'^{-1})),  m' = L' L'^T theta_1'

S^{-1} is carried from step to step (the first from the initial factor).
A VM step is adam on the hypers, Z and W, as ``svgp`` has it; the q leaves
take no adam step, and adam's moments of every other leaf decay at a VE
step, its count ticking with every step.

Departures from Salimbeni et al., both the measured program's and stated
in the configuration:

* the jitter: the configuration's fixed jitter is added to each new
  precision S'^{-1}, which is then exactly the inverse of L' L'^T;
* the acceptance rule: a step whose m' or L' is not finite (or whose
  S'^{-1} is not positive definite), that moves a whitened mean by
  ``mean_move_below`` or more, or that gives a variance (a diagonal entry
  of S') of ``variance_below`` or more is tried again at lr / 4, and that
  one failing too, q and S^{-1} are kept.  The step's code is 0, 1 or 2.

``precision="float64"`` is the judge; ``"tf32"`` is the control: float32,
every product of the ELBO's moments rounded to TF32 as ``svgp``'s are, the
step's own algebra in float32 with TF32 matmuls off.

Nothing here imports the measured program.
"""

from __future__ import annotations

import contextlib

import torch

from hmbench.reference import svgp

ADAM_LEAVES = tuple(n for n in svgp.LEAVES if n not in svgp.VE_FREE)


@contextlib.contextmanager
def _no_tf32():
    """float32 matmuls in float32: the card's default, stated."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class Reference(svgp.Reference):
    """The natural-gradient trainer's reference at one precision on one
    device; its ELBO takes the covariance S as ``p["S"]`` where given."""

    def __init__(self, config: dict, device, precision: str = "float64"):
        super().__init__(config, device, precision)
        rule = config["assumed"]["natgrad_accept"]
        self.ng_lr = config["train"]["natgrad_lr"]
        self.step_max = rule["mean_move_below"]
        self.var_max = rule["variance_below"]

    # ---- the ELBO in (m, S) ---------------------------------------------
    def latent(self, p, X, iL):
        if "S" not in p:
            return super().latent(p, X, iL)
        ls, var = torch.exp(p["log_lengthscale"]), torch.exp(p["log_variance"])
        P = self.mm(self.kern(X, p["Z"], ls, var), iL.mT)
        mean = self.mm(P, p["q_mu"][..., None])[..., 0]
        kdiag = var[:, None].expand(self.Q, X.shape[0])
        gamma = kdiag + torch.sum(self.mm(P, p["S"]) * P, -1) - torch.sum(P * P, -1)
        return mean, gamma, kdiag

    def kl(self, p):
        if "S" not in p:
            return super().kl(p)
        S = p["S"]
        trace = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
        return torch.sum(0.5 * (trace + torch.sum(p["q_mu"] ** 2, -1) - self.M
                                - torch.logdet(S)))

    # ---- the natural-gradient step -----------------------------------------
    def ve_step(self, p, S_inv, batch, scales):
        """(ELBO before, m', L', S'^{-1}, code) of one step from (m, L) =
        (p["q_mu"], tril(p["q_sqrt"])) and the carried S^{-1}."""
        m, L = p["q_mu"], torch.tril(p["q_sqrt"])
        with _no_tf32():
            m_, S_ = m.clone().requires_grad_(), self.mm(L, L.mT).requires_grad_()
            with torch.enable_grad():
                e = self.elbo(dict(p, q_mu=m_, S=S_), batch, scales)
                g_m, g_S = torch.autograd.grad(e, [m_, S_])
            g_S = 0.5 * (g_S + g_S.mT)
            theta1 = (S_inv @ m[..., None])[..., 0]
            d1 = g_m - 2.0 * (g_S @ m[..., None])[..., 0]
            eye = torch.eye(self.M, dtype=m.dtype, device=m.device)
            for code, lr in enumerate((self.ng_lr, 0.25 * self.ng_lr)):
                prec = S_inv - 2.0 * lr * g_S + self.jitter * eye
                L_new, info = torch.linalg.cholesky_ex(torch.linalg.inv(prec))
                m_new = (L_new @ (L_new.mT @ (theta1 + lr * d1)[..., None]))[..., 0]
                var = torch.sum(L_new * L_new, -1)  # the diagonal of S'
                if (bool((info == 0).all()) and bool(torch.isfinite(m_new).all())
                        and bool(torch.isfinite(L_new).all())
                        and float((m_new - m).abs().max()) < self.step_max
                        and float(var.max()) < self.var_max):
                    return float(e.detach()), m_new, L_new, prec, code
        return float(e.detach()), m, L, S_inv, 2

    # ---- the schedule ------------------------------------------------------
    def train_steps(self, params0, steps, free_vm, lr, skip_ve=False):
        """The natural-gradient and adam steps of the schedule from
        ``params0``.  steps: per step (kind "ve" or "vm", batch
        [(X_t, Y_t)], scales).  ``skip_ve`` keeps q at every VE step, as a
        step whose two attempts both fail does (a fault's reading).

        Returns (ELBOs before each update, {leaf: gradient of -ELBO at the
        VM step where it is first free}, params after, the carried S^{-1}
        after, the VE steps' codes)."""
        with _no_tf32():
            return self._train_steps(params0, steps, free_vm, lr, skip_ve)

    def _train_steps(self, params0, steps, free_vm, lr, skip_ve):
        p = self.cast(params0)
        S_inv = torch.cholesky_inverse(torch.tril(p["q_sqrt"]))
        names = list(ADAM_LEAVES) + [f"lik_theta.{t}" for t in range(len(self.liks))]

        def get(q, name):
            return q["lik_theta"][int(name.split(".")[1])] if "." in name else q[name]

        def put(q, name, t):
            if "." in name:
                q["lik_theta"][int(name.split(".")[1])] = t
            else:
                q[name] = t

        mu = {n: torch.zeros_like(get(p, n)) for n in names}
        nu = {n: torch.zeros_like(get(p, n)) for n in names}
        elbos, first, codes = [], {}, []
        for count, (kind, batch, scales) in enumerate(steps, start=1):
            grads = {}
            if kind == "ve":
                e, m_new, L_new, S_new, code = self.ve_step(p, S_inv, batch, scales)
                if skip_ve:
                    code = 2
                else:
                    p["q_mu"], p["q_sqrt"], S_inv = m_new, L_new, S_new
                codes.append(code)
            else:
                free = [n for n in names if n.split(".")[0] in free_vm
                        and get(p, n).numel()]
                q = {k: (v.clone() if k != "lik_theta" else list(v)) for k, v in p.items()}
                for n in free:
                    put(q, n, get(p, n).clone().requires_grad_())
                with torch.enable_grad():
                    ev = self.elbo(q, batch, scales)
                    grads = dict(zip(free, torch.autograd.grad(
                        -ev, [get(q, n) for n in free])))
                e = float(ev.detach())
            elbos.append(e)
            bc1, bc2 = 1.0 - svgp.B1 ** count, 1.0 - svgp.B2 ** count
            for n in names:
                g = grads.get(n)
                if g is None:
                    mu[n], nu[n] = svgp.B1 * mu[n], svgp.B2 * nu[n]
                    continue
                first.setdefault(n, g.detach())
                mu[n] = (1.0 - svgp.B1) * g + svgp.B1 * mu[n]
                nu[n] = (1.0 - svgp.B2) * g * g + svgp.B2 * nu[n]
                put(p, n, get(p, n) - lr * (mu[n] / bc1)
                    / (torch.sqrt(nu[n] / bc2) + svgp.EPS))
            p = {k: (v.detach() if k != "lik_theta" else [t.detach() for t in v])
                 for k, v in p.items()}
        return elbos, first, p, S_inv, codes
