"""``models/elbo.py::likelihood_term``, forward and backward (to the
moments and the trainable theta), at the cell's VE batch from the trained
state: one call captured as a CUDA graph and replayed, each replay timed by
CUDA events behind a device sleep; the median of the replays, in ms."""

import dataclasses

import torch

from hmbench.timing import graph_ms


def read(layer):
    prog = layer.get("program")
    if layer.get("kind") != "train" or prog is None:
        return None
    from hetmogp_tpu_torch.models import elbo as elbo_mod

    config, state, dataset, B = prog["config"], prog["state"], prog["dataset"], prog["B"]
    N = prog["batch"]
    offs = prog["rng"].integers(0, min(N) - B, size=len(dataset))
    data = tuple(elbo_mod.TaskData(*(a[o:o + B] for a in td))
                 for td, o in zip(dataset, offs.tolist()))
    scales = torch.tensor([n / B for n in N], dtype=data[0].X.dtype,
                          device=data[0].X.device)
    params = state.params
    with torch.no_grad():
        moments = elbo_mod.fused_task_moments(params, config, state.Luu, data, state.iLuu)
    M = [m.detach().clone().requires_grad_() for m, _ in moments]
    V = [v.detach().clone().requires_grad_() for _, v in moments]
    theta = None
    if params.lik_theta is not None:
        theta = tuple(t.detach().clone().requires_grad_(t.numel() > 0)
                      for t in params.lik_theta)
        params = dataclasses.replace(params, lik_theta=theta)
    wrt = M + V + [t for t in theta or () if t.numel()]

    def body():
        ve = elbo_mod.likelihood_term(params, config, data, list(zip(M, V)), scales)
        torch.autograd.grad(ve.sum(), wrt)

    return graph_ms(body, prog["repeats"])
