"""Gauss-Hermite expectations of a log-density, in plain PyTorch.

The value is the T-node (per dimension) Gauss-Hermite sum of the
log-density at F = m + sqrt(2 v) t; its gradient with respect to (m, v) is
the Bonnet/Price pair (E[d logp/df], 1/2 E[d2 logp/df2]) on the same nodes,
and with respect to a shared parameter vector theta the derivative of the
sum.  These are the gradient semantics the measured program states for its
quadrature engines, so the reference differentiates the same quantity.

Nothing here imports the measured program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def grid(T: int, J: int):
    """(nodes (T^J, J), weights (T^J,)) of the tensor-product Gauss-Hermite
    rule, the weights divided by pi^(J/2), as float64 numpy arrays."""
    t, w = np.polynomial.hermite.hermgauss(T)
    nodes = np.stack([g.reshape(-1) for g in
                      np.meshgrid(*([t] * J), indexing="ij")], axis=-1)
    weights = np.prod(np.stack([g.reshape(-1) for g in
                                np.meshgrid(*([w] * J), indexing="ij")],
                               axis=-1), axis=-1)
    return nodes, weights / np.pi ** (J / 2.0)


def _second(d1, F, j):
    if not d1.requires_grad:
        return torch.zeros_like(F[..., j])
    (g,) = torch.autograd.grad(d1[..., j].sum(), F, retain_graph=True,
                               allow_unused=True)
    return torch.zeros_like(F[..., j]) if g is None else g[..., j]


class _Expect(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logpdf, T, J, y, m, v, theta):
        nodes, w = (torch.as_tensor(a, dtype=m.dtype, device=m.device)
                    for a in grid(T, J))
        n = m.shape[0]
        with torch.enable_grad():
            F = (m.detach()[:, None, :] + torch.sqrt(2.0 * v.detach())[:, None, :]
                 * nodes[None]).requires_grad_()
            th = None
            if theta is not None:
                th = theta.detach().reshape(1, 1, -1).expand(
                    n, 1, theta.shape[-1]).clone().requires_grad_()
            lp = logpdf(F, y[:, None, :], th)  # (N, S)
            wanted = (F,) if th is None else (F, th)
            grads = torch.autograd.grad(lp, wanted, grad_outputs=w.expand_as(lp),
                                        create_graph=True)
            d1w = grads[0]
            d2w = torch.stack([_second(d1w, F, j) for j in range(J)], dim=-1)
        ctx.save_for_backward(d1w.detach().sum(1), d2w.detach().sum(1),
                              None if th is None else grads[1].detach()[:, 0])
        ctx.has_theta = th is not None
        return lp.detach() @ w

    @staticmethod
    def backward(ctx, g):
        Ed1, Ed2, Edt = ctx.saved_tensors
        dtheta = (Edt.mT @ g) if ctx.has_theta else None
        return (None, None, None, None, Ed1 * g[:, None],
                0.5 * Ed2 * g[:, None], dtheta)


def expect(logpdf, y, m, v, T: int, theta=None):
    """Per row, E_{N(f; m, v)}[logpdf(f, y, theta)] on the T^J grid: (N,).

    logpdf(F (N, S, J), Y (N, 1, dim_y), theta (N, 1, P) or None) -> (N, S).
    """
    return _Expect.apply(logpdf, T, m.shape[-1], y, m, v, theta)


def predictive(cond_moments, m, v, T: int):
    """Observation-space moments by the same rule: E[mean(f)] and
    E[var(f)] + E[mean(f)^2] - E[mean(f)]^2, each (N, dim_p)."""
    nodes, w = (torch.as_tensor(a, dtype=m.dtype, device=m.device)
                for a in grid(T, m.shape[-1]))
    F = m[:, None, :] + torch.sqrt(2.0 * v)[:, None, :] * nodes[None]
    cm, cv = cond_moments(F)
    Em = cm.mT @ w
    return Em, cv.mT @ w + torch.square(cm).mT @ w - torch.square(Em)
