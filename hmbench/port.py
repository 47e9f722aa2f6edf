"""The measured program, hetmogp_tpu_torch, built from a configuration file
through its public entry points: the model and train configs, the
parameters and the task data the harness made from the seed.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import likelihoods
from hetmogp_tpu_torch.models import elbo as elbo_mod
from hetmogp_tpu_torch.models.params import leaves


def model_config(cfg: dict, precision: str) -> tp.ModelConfig:
    liks = tuple(getattr(likelihoods, e["family"])(**e.get("args", {}))
                 for e in cfg["likelihoods"])
    return tp.ModelConfig(likelihoods=liks, num_latent=cfg["num_latent"],
                          num_inducing=cfg["num_inducing"],
                          input_dim=cfg["input_dim"], dtype=cfg["dtype"],
                          jitter=cfg["jitter"], adaptive_jitter=False,
                          whiten=cfg["whiten"], kernel=cfg["kernel"],
                          fuse_task_rows=cfg["fuse_task_rows"],
                          ve_fwd_precision=precision)


def train_config(cfg: dict) -> tp.TrainConfig:
    t = cfg["train"]
    return tp.TrainConfig(optimizer=t["optimizer"], step_rate=t["step_rate"],
                          minibatch=t["minibatch"],
                          vm_batch_fraction=t["vm_batch_fraction"],
                          ve_steps_per_vm=t["ve_steps_per_vm"],
                          learn_lik_params=t["learn_lik_params"])


def params(p: dict) -> "tp.SVMOGPParams":
    theta = None if p["lik_theta"] is None else tuple(p["lik_theta"])
    return tp.SVMOGPParams(p["Z"], p["q_mu"], p["q_sqrt"], p["log_lengthscale"],
                           p["log_variance"], p["W"], p["kappa"],
                           lik_theta=theta, rank=1)


def param_leaves(params_obj) -> dict:
    """{leaf name: tensor} of the program's params, theta as lik_theta.<t>."""
    out, t = {}, 0
    for name, tensor in leaves(params_obj):
        if name == "lik_theta":
            out[f"lik_theta.{t}"] = tensor
            t += 1
        else:
            out[name] = tensor
    return out


def dataset(data: list) -> tuple:
    return tuple(elbo_mod.task_data(X, Y, device=X.device) for X, Y in data)


def init_state(params_obj, config, train_cfg, first_step: int):
    state = tp.init_train_state(params_obj, config, train_cfg)
    return dataclasses.replace(state, step=first_step)


def adam_moments(state) -> dict:
    """{leaf name: the first moment of adam's state}, cloned."""
    return {k: v.detach().clone() for k, v in param_leaves(state.opt_state.mu).items()}


def launch_counts() -> dict:
    from hetmogp_tpu_torch.ops import cuda_kernels
    return cuda_kernels.launch_counts()


class Shape(tuple):
    """A tensor argument of a recorded launch: its shape."""


def _summary(a):
    if isinstance(a, torch.Tensor):
        return Shape(a.shape)
    if isinstance(a, (list, tuple)):
        return [_summary(x) for x in a]
    return a if a is None or isinstance(a, (bool, int, float, str)) else type(a).__name__


class _Recorder:
    """A launcher of the program's kernels, called through: each call's
    arguments as shapes, whether the current stream was capturing a CUDA
    graph, and the launches the call made on the launcher's counter."""

    def __init__(self, name: str, fn, log: list):
        self.name, self.fn, self.log, self.__name__ = name, fn, log, fn.__name__

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kwargs):
        before = self.fn.launches
        out = self.fn(*args, **kwargs)
        self.log.append(dict(launcher=self.name, args=_summary(args),
                             kwargs={k: _summary(v) for k, v in kwargs.items()},
                             capturing=(torch.cuda.is_available()
                                        and torch.cuda.is_current_stream_capturing()),
                             launches=self.fn.launches - before))
        return out


@contextlib.contextmanager
def record_launches():
    """Yields the list of the launches made inside the block by every
    launcher that the program's launch counters name: the routers look
    their launchers up in the module at each call, so recorders put there
    see every launch, the graphs' capture included."""
    from hetmogp_tpu_torch.ops import cuda_kernels

    log, originals = [], {}
    for name in launch_counts():
        fn = getattr(cuda_kernels, name, None)
        if callable(fn) and hasattr(fn, "launches"):
            originals[name] = fn
            setattr(cuda_kernels, name, _Recorder(name, fn, log))
    try:
        yield log
    finally:
        for name, fn in originals.items():
            setattr(cuda_kernels, name, fn)


def empty_launch() -> None:
    from hetmogp_tpu_torch.ops import cuda_kernels
    cuda_kernels.empty_launch()


def serving_fns(params_obj, config) -> list:
    return [tp.make_serving_predictive(params_obj, config, t)
            for t in range(config.num_tasks)]


def load_kernels(device) -> None:
    if torch.device(device).type == "cuda":
        from hetmogp_tpu_torch.ops import cuda_kernels
        cuda_kernels.load()
