"""Large-scale LMC training (the flagship configuration) on the port.

N=1e6 points across 6 mixed likelihoods, M=1024 inducing points, Q=4
latent GPs, trained by the graphed on-device loop (the dataset on the
card, one captured CUDA graph per step kind) at the bench's production
settings: a fixed jitter floor, 3-pass bf16 VE projections
(``ve_fwd_precision="high"``), contiguous-slice minibatches and VM hyper
gradients from a quarter of the batch.

Run:  python -m hetmogp_tpu_torch.examples.large_scale --device cuda
      [--steps 1000] [--natgrad]
"""

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--natgrad", action="store_true")
    args = ap.parse_args(argv)

    from hetmogp_tpu_torch import (Bernoulli, Categorical, Exponential, Gamma,
                                   HetGaussian, ModelConfig, Poisson,
                                   TrainConfig)
    from hetmogp_tpu_torch import train as train_mod
    from hetmogp_tpu_torch.models.params import init_params

    liks = (HetGaussian(), Bernoulli(), Categorical(K=3), Poisson(), Gamma(),
            Exponential())
    T = len(liks)
    n_per = args.n // T
    rng = np.random.RandomState(0)
    Dx = 2
    X_list = [rng.rand(n_per, Dx).astype(np.float32) for _ in range(T)]
    Y_list = [rng.randn(n_per, 1),
              (rng.rand(n_per, 1) > 0.5).astype(float),
              rng.randint(1, 4, (n_per, 1)).astype(float),
              rng.poisson(3.0, (n_per, 1)).astype(float),
              rng.gamma(2.0, 1.0, (n_per, 1)) + 1e-3,
              rng.exponential(1.0, (n_per, 1)) + 1e-3]
    cfg = ModelConfig(likelihoods=liks, num_latent=args.q,
                      num_inducing=args.m, input_dim=Dx, dtype="float32",
                      jitter=1e-4, adaptive_jitter=False,
                      ve_fwd_precision="high")
    tc = TrainConfig(optimizer="natgrad_adam" if args.natgrad else "adam",
                     step_rate=0.005, natgrad_lr=0.1, minibatch="slice",
                     vm_batch_fraction=0.25)
    params = init_params(np.random.default_rng(0), cfg,
                         rng.rand(args.m, Dx).astype(np.float32),
                         lengthscale=0.2, variance=0.5, q_mu_scale=0.1,
                         device=args.device)

    # the dataset goes to the device once and is reused across calls
    dataset = train_mod.prepare_dataset_on_device(cfg, X_list, Y_list,
                                                  device=args.device)
    chunk = min(500, args.steps)
    # a warm-up call so that the rate is steady state, not capture time
    params, _ = train_mod.svi_fit_on_device(
        params, cfg, tc, X_list, Y_list, args.batch, args.warmup,
        generator=torch.Generator().manual_seed(9), steps_per_call=chunk,
        dataset=dataset)
    if args.device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist = train_mod.svi_fit_on_device(
        params, cfg, tc, X_list, Y_list, args.batch, args.steps,
        generator=torch.Generator().manual_seed(1), steps_per_call=chunk,
        dataset=dataset)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"{args.steps} steps in {dt:.1f}s = {args.steps / dt:.1f} steps/s "
          f"on {where}")
    print(f"ELBO: {hist[0]:.0f} -> {hist[-1]:.0f}")
    return hist


if __name__ == "__main__":
    main()
