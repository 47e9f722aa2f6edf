"""``ops/linalg.py::blocked_cholesky_inverse`` of the cell's (Q, M, M)
Kuu + jitter at the trained state's hypers: one call captured as a CUDA
graph and replayed, each replay timed by CUDA events behind a device
sleep; the median of the replays, in ms."""

import torch

from hmbench.timing import graph_ms


def read(layer):
    prog = layer.get("program")
    if layer.get("kind") != "train" or prog is None:
        return None
    from hetmogp_tpu_torch.ops import kernels, linalg

    config, p = prog["config"], prog["state"].params
    with torch.no_grad():
        K = kernels.K_gram_batched(config.kernel, p.Z, p.lengthscale, p.variance)
        K = K + config.jitter * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        return graph_ms(lambda: linalg.blocked_cholesky_inverse(K), prog["repeats"])
