"""Model-parallel (latent axis) and data-parallel training over a 2-D mesh.

The two axes of ``hetmogp_tpu_torch.parallel``:

* data: each step's minibatch rows split over the data ranks (the ELBO is
  a sum over rows), the gradients all-reduced over them;
* latent: the Q-leading state (q_mu, q_sqrt, Z, the hypers, the cached
  Luu and Luu^{-1}) split over latent GPs, so each rank factorizes and
  projects its own latents and the mixing sum over q is an all-reduce.

Two ways to run it:

    python -m hetmogp_tpu_torch.examples.model_parallel --spawn 4 \\
        --device cpu [--latent 2] [--steps 100]

starts four gloo ranks on this host (``parallel.spawn_local``); and

    torchrun --nproc-per-node 4 -m hetmogp_tpu_torch.examples.model_parallel \\
        --device cuda --latent 2

runs one rank a GPU over NCCL, the collectives captured in the graphed
trainer's CUDA graphs.
"""

import argparse
import time

import numpy as np
import torch


def _train(rank, world, args):
    from hetmogp_tpu_torch import (Bernoulli, Gamma, HetGaussian, ModelConfig,
                                   TrainConfig)
    from hetmogp_tpu_torch import train as train_mod
    from hetmogp_tpu_torch.models.params import init_params
    from hetmogp_tpu_torch.parallel import sharding

    device = args["device"]
    liks = (HetGaussian(), Bernoulli(), Gamma())
    Q, M, n_per = max(args["latent"], 2), args["m"], args["n"] // len(liks)
    cfg = ModelConfig(likelihoods=liks, num_latent=Q, num_inducing=M,
                      input_dim=1, dtype="float32", jitter=1e-4,
                      adaptive_jitter=False)
    # every rank makes the same data and parameters from the same seed
    rng = np.random.RandomState(0)
    X_list = [rng.rand(n_per, 1).astype(np.float32) for _ in liks]
    Y_list = [rng.randn(n_per, 1), (rng.rand(n_per, 1) > 0.5).astype(float),
              rng.gamma(2.0, 1.0, (n_per, 1)) + 1e-3]
    params = init_params(np.random.default_rng(0), cfg,
                         np.linspace(0, 1, M)[:, None], lengthscale=0.2,
                         variance=0.5, q_mu_scale=0.1, device=device)
    tc = TrainConfig(optimizer="adam", step_rate=0.01, minibatch="slice")
    mesh = sharding.model_mesh(device, latent=args["latent"])
    if rank == 0:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{world} {device} ranks")
    dataset = train_mod.prepare_dataset_on_device(cfg, X_list, Y_list,
                                                  device=device, mesh=mesh)
    gen = torch.Generator().manual_seed(1)

    def fit(p):
        return train_mod.svi_fit_on_device(
            p, cfg, tc, X_list, Y_list, args["batch"], args["steps"],
            generator=gen, steps_per_call=args["steps"], mesh=mesh,
            dataset=dataset)

    params, first = fit(params)  # capture (or warm-up) and run
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, second = fit(params)
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rank == 0:
        print(f"{args['steps']} steps in {dt:.2f}s = "
              f"{args['steps'] / dt:.1f} steps/s")
        # the whole trajectory: the first call does most of the improving
        print(f"ELBO: {first[0]:.1f} -> {second[-1]:.1f} over "
              f"{2 * args['steps']} steps")
        local = sharding.shard_params(mesh, params).q_sqrt.shape
        print(f"q_sqrt: {tuple(params.q_sqrt.shape)} in all, "
              f"{tuple(local)} on each rank")
    return np.concatenate([first, second])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many local ranks (gloo); 0: the ranks "
                         "are torchrun's")
    ap.add_argument("--latent", type=int, default=2,
                    help="latent-axis size (divides the ranks and Q)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--n", type=int, default=12_288)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    kw = dict(device=args.device, latent=args.latent, steps=args.steps,
              n=args.n, m=args.m, batch=args.batch)
    if args.spawn:
        from hetmogp_tpu_torch.parallel import spawn_local

        return spawn_local(_train, args.spawn, args.device, "gloo",
                           args=(kw,), timeout=120,
                           threads=1 if args.device == "cpu" else None)[0]
    import os

    import torch.distributed as dist

    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        return _train(dist.get_rank(), dist.get_world_size(), kw)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
