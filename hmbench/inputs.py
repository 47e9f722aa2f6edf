"""What a run feeds the program, made from ``--seed`` on the run's device:
the initial parameters and the task data of a configuration.

One ``torch.Generator`` on the device, a few large draws, float32 as the
configuration states; the same seed gives the same inputs on one device.
Plain PyTorch: the reference is handed the same tensors.
"""

from __future__ import annotations

import math

import torch

from hmbench.reference import families


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63))
    return g


def dims(cfg: dict):
    """(Q, M, Dx, D): latents, inducing points, input width, output functions."""
    D = sum(families.build(e).dim_f for e in cfg["likelihoods"])
    return cfg["num_latent"], cfg["num_inducing"], cfg["input_dim"], D


def init_params(cfg: dict, gen: torch.Generator, device, serving=False) -> dict:
    """Z ~ U[0,1)^(M x Dx) shared by the latents, q_mu = s N(0, 1), q_sqrt the
    identity (training) or d I + e tril(N(0, 1)) (serving), the stated
    lengthscale and variance, W with entries N(+-0.5, 0.5^2) of random
    sign, kappa 0, and each family's initial theta where it learns any."""
    Q, M, Dx, D = dims(cfg)
    init = cfg["init"]
    kw = dict(dtype=torch.float32, device=device)
    Z = torch.rand((M, Dx), generator=gen, **kw).expand(Q, M, Dx).contiguous()
    q_mu = init["q_mu_scale"] * torch.randn((Q, M), generator=gen, **kw)
    eye = torch.eye(M, **kw).expand(Q, M, M)
    if serving:
        s = cfg["serve"]
        q_sqrt = (s["q_sqrt_diag"] * eye + s["q_sqrt_noise"]
                  * torch.tril(torch.randn((Q, M, M), generator=gen, **kw)))
    else:
        q_sqrt = eye.contiguous()
    sign = torch.rand((Q, D), generator=gen, **kw) < 0.5
    W = torch.where(sign, 0.5, -0.5) + 0.5 * torch.randn((Q, D), generator=gen, **kw)
    liks = [families.build(e) for e in cfg["likelihoods"]]
    theta = None
    if cfg.get("train", {}).get("learn_lik_params") and not serving:
        theta = [torch.tensor(lik.theta0(), **kw) for lik in liks]
    return {"Z": Z, "q_mu": q_mu, "q_sqrt": q_sqrt,
            "log_lengthscale": torch.full((Q, 1), math.log(init["lengthscale"]), **kw),
            "log_variance": torch.full((Q,), math.log(init["variance"]), **kw),
            "W": W, "kappa": torch.zeros((Q, D), **kw), "lik_theta": theta}


def _iid(spec: dict, n: int, gen, kw):
    kind = spec["draw"]
    if kind == "normal":
        return torch.randn((n, 1), generator=gen, **kw)
    if kind == "bernoulli":
        return (torch.rand((n, 1), generator=gen, **kw) < spec["p"]).float()
    if kind == "integers":
        return torch.randint(spec["low"], spec["high"] + 1, (n, 1), generator=gen,
                             device=kw["device"]).float()
    if kind == "poisson":
        return torch.poisson(torch.full((n, 1), spec["rate"], **kw), generator=gen)
    if kind == "gamma":
        return torch._standard_gamma(torch.full((n, 1), spec["shape"], **kw),
                                     generator=gen) + spec["offset"]
    if kind == "exponential":
        u = torch.rand((n, 1), generator=gen, **kw)
        return -torch.log1p(-u) + spec["offset"]
    raise ValueError(f"unknown draw {kind!r}")


def task_data(cfg: dict, gen: torch.Generator, device) -> list:
    """[(X_t, Y_t)] per task: X ~ U[0,1)^Dx, Y either drawn on its own
    (``"y"``) or from the family with its true parameters at
    f_d(x) = c_d + a_d sin(2 pi w_d . x + phi_d) (``"truth"``, ``"f_shape"``)."""
    Q, M, Dx, D = dims(cfg)
    n, T = cfg["rows_per_task"], len(cfg["likelihoods"])
    kw = dict(dtype=torch.float32, device=device)
    X = torch.rand((T, n, Dx), generator=gen, **kw)
    w = 2.0 * torch.rand((D, Dx), generator=gen, **kw)
    phi = 2.0 * math.pi * torch.rand((D,), generator=gen, **kw)
    out, d = [], 0
    for t, entry in enumerate(cfg["likelihoods"]):
        if "y" in entry:
            Y = _iid(entry["y"], n, gen, kw)
        else:
            truth = families.build({"family": entry["family"], "args": entry["truth"]})
            c = torch.tensor([s[0] for s in entry["f_shape"]], **kw)
            a = torch.tensor([s[1] for s in entry["f_shape"]], **kw)
            J = len(entry["f_shape"])
            F = c + a * torch.sin(2.0 * math.pi * X[t] @ w[d:d + J].T + phi[d:d + J])
            Y = truth.sample(gen, F.double()).float()
            d += J
            out.append((X[t], Y))
            continue
        d += families.build(entry).dim_f
        out.append((X[t], Y))
    return out
