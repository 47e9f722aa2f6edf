"""Optimizer convergence comparison on the port.

Adam vs Adadelta (the reference's default) vs natural-gradient+Adam on a
demo-style HetGaussian+Bernoulli workload, 200 SVI steps each.  Float64
on the CPU, as the JAX package runs it; float32 on the card, where the
hand kernels take float32 only.

Run:  python -m hetmogp_tpu_torch.examples.optimizers --device cpu
"""

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)

    from hetmogp_tpu_torch import (Bernoulli, HetGaussian, ModelConfig,
                                   TrainConfig)
    from hetmogp_tpu_torch import train as train_mod
    from hetmogp_tpu_torch.data import MinibatchStream, full_batch
    from hetmogp_tpu_torch.models import elbo as elbo_mod
    from hetmogp_tpu_torch.models.params import init_params

    rng = np.random.RandomState(0)
    n = 400
    X = [np.sort(rng.rand(n, 1), 0), np.sort(rng.rand(n, 1), 0)]
    Y = [np.sin(6 * X[0]) + 0.3 * rng.randn(n, 1),
         (rng.rand(n, 1) < 1 / (1 + np.exp(-3 * np.sin(8 * X[1]))))
         .astype(float)]
    dtype = "float64" if args.device == "cpu" else "float32"
    cfg = ModelConfig(likelihoods=(HetGaussian(), Bernoulli()), num_latent=2,
                      num_inducing=16, input_dim=1, dtype=dtype)
    params0 = init_params(np.random.default_rng(0), cfg,
                          np.linspace(0, 1, 16)[:, None], lengthscale=0.15,
                          variance=0.5, q_mu_scale=0.3, device=args.device)
    data, scales = full_batch(X, Y, dtype=cfg.torch_dtype,
                              device=args.device)
    scales = torch.as_tensor(scales, dtype=cfg.torch_dtype,
                             device=args.device)

    configs = [
        ("adam", TrainConfig(optimizer="adam", step_rate=0.01)),
        ("adadelta (reference default)",
         TrainConfig(optimizer="adadelta", step_rate=0.05)),
        ("natgrad_adam",
         TrainConfig(optimizer="natgrad_adam", step_rate=0.01,
                     natgrad_lr=0.3)),
    ]
    print(f"{'optimizer':32s} {'ELBO@50':>10s} {'ELBO@end':>10s} "
          f"{'full-data':>10s}")
    results = {}
    for name, tc in configs:
        stream = MinibatchStream(X, Y, 100, shuffle=True, seed=1,
                                 dtype=cfg.torch_dtype, device=args.device)
        p, hist = train_mod.svi_fit(params0, cfg, tc, stream, args.steps,
                                    vem=True)
        with torch.no_grad():
            full = float(elbo_mod.elbo_fn(p, data, scales, cfg)[0])
        results[name] = (hist, full)
        print(f"{name:32s} {np.mean(hist[45:55]):10.1f} "
              f"{np.mean(hist[-10:]):10.1f} {full:10.1f}")
    return results


if __name__ == "__main__":
    main()
