"""Count and positive-valued outputs on the port.

Poisson + Gamma + Beta outputs, N = 200k, M = 512, minibatch SVI through
the graphed on-device loop (fixed jitter: the captured graph cannot read
the adaptive escalation's factorization info on the host).

Run:  python -m hetmogp_tpu_torch.examples.counts --device cuda
      [--steps 1000]
"""

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--m", type=int, default=512)
    args = ap.parse_args(argv)

    from hetmogp_tpu_torch import Beta, Gamma, ModelConfig, Poisson, \
        TrainConfig
    from hetmogp_tpu_torch import train as train_mod
    from hetmogp_tpu_torch.models.params import init_params

    liks = (Poisson(), Gamma(), Beta())
    T = len(liks)
    n_per = args.n // T
    rng = np.random.RandomState(0)
    Dx, Q = 2, 3
    X_list = [rng.rand(n_per, Dx).astype(np.float32) for _ in range(T)]
    Y_list = [rng.poisson(3.0, (n_per, 1)).astype(float),
              rng.gamma(2.0, 1.0, (n_per, 1)) + 1e-3,
              np.clip(rng.beta(2.0, 2.0, (n_per, 1)), 1e-3, 1 - 1e-3)]
    cfg = ModelConfig(likelihoods=liks, num_latent=Q, num_inducing=args.m,
                      input_dim=Dx, dtype="float32", jitter=1e-6,
                      adaptive_jitter=False)
    tc = TrainConfig(optimizer="adam", step_rate=0.01)
    params = init_params(np.random.default_rng(0), cfg,
                         rng.rand(args.m, Dx).astype(np.float32),
                         lengthscale=0.3, variance=0.5, q_mu_scale=0.1,
                         device=args.device)
    batch = min(512, n_per)
    # a warm-up call so that the rate is steady state, not capture time
    params, _ = train_mod.svi_fit_on_device(
        params, cfg, tc, X_list, Y_list, batch, args.warmup,
        generator=torch.Generator().manual_seed(9))
    t0 = time.perf_counter()
    params, hist = train_mod.svi_fit_on_device(
        params, cfg, tc, X_list, Y_list, batch, args.steps,
        generator=torch.Generator().manual_seed(1))
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s = {args.steps / dt:.1f} steps/s")
    print(f"ELBO: {hist[0]:.0f} -> {hist[-1]:.0f}")
    return hist


if __name__ == "__main__":
    main()
