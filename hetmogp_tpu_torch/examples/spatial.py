"""Spatial heterogeneous model on the port.

2-D spatial inputs; output 1 is a heteroscedastic Gaussian (e.g.
log-price) and output 2 a 3-way categorical (e.g. property type), sharing
Q latent spatial GPs.  By default the data is synthetic with known latent
structure (N ~ 50k, M = 256); ``--data FILE`` runs the same model on a
table instead (``data.load_spatial_table``):

  CSV   header x1,x2,task,y: task 0 rows are the real-valued output, task
        1 rows the categorical label (1..K)
  NPZ   per-task arrays X0,Y0,X1,Y1

The repository's sample exercises that path:
  python -m hetmogp_tpu_torch.examples.spatial --device cuda \\
      --data examples/data/spatial_sample.csv

Nothing is downloaded.
"""

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--data", type=str, default=None,
                    help="a table (CSV: x1,x2,task,y / NPZ: X0,Y0,X1,Y1); "
                         "see hetmogp_tpu_torch.data.load_spatial_table")
    args = ap.parse_args(argv)

    from hetmogp_tpu_torch import (Categorical, HetGaussian, HetLikelihood,
                                   ModelConfig, TrainConfig)
    from hetmogp_tpu_torch import train as train_mod
    from hetmogp_tpu_torch.models import predict as predict_mod
    from hetmogp_tpu_torch.models.params import init_params, random_W

    rng = np.random.RandomState(0)
    Q, Dx = 3, 2

    def latent(X, seed):
        """Smooth random Fourier features: a synthetic spatial latent."""
        r = np.random.RandomState(seed)
        w = r.randn(8, Dx) * 3.0
        a = r.randn(8)
        return np.cos(X @ w.T + r.rand(8) * 2 * np.pi) @ a / np.sqrt(8)

    if args.data is not None:
        from hetmogp_tpu_torch.data import load_spatial_table

        X_list, Y_list = load_spatial_table(args.data)
        if len(X_list) != 2 or X_list[0].shape[1] != Dx:
            raise SystemExit(
                f"--data expects 2 tasks with {Dx}-D inputs (HetGaussian + "
                f"Categorical); got {len(X_list)} tasks, "
                f"Dx={X_list[0].shape[1]}")
        K = int(Y_list[1].max())
        het = HetLikelihood([HetGaussian(), Categorical(K=max(K, 2))])
        X1, X2 = X_list
        Y1, Y2 = Y_list
        # standardize the real-valued output (log-price scale varies)
        Y1 = (Y1 - Y1.mean()) / max(Y1.std(), 1e-9)
        print(f"loaded {args.data}: task sizes {len(X1)}/{len(X2)}, "
              f"K={max(K, 2)}")
        args.m = min(args.m, max(8, (len(X1) + len(X2)) // 4))
        W = None
    else:
        het = HetLikelihood([HetGaussian(), Categorical(K=3)])
        D = het.num_output_functions()
        n_per = args.n // 2
        X1, X2 = rng.rand(n_per, Dx), rng.rand(n_per, Dx)
        W = random_W(np.random.default_rng(2), Q, D)
        U1 = np.stack([latent(X1, q) for q in range(Q)], axis=1)
        U2 = np.stack([latent(X2, q) for q in range(Q)], axis=1)
        Y1, Y2 = (y.numpy() for y in het.samples(
            torch.Generator().manual_seed(3), [U1 @ W[:, 0:2],
                                               U2 @ W[:, 2:4]]))

    # a fixed jitter floor: the graphed loop cannot run the adaptive one
    cfg = ModelConfig(likelihoods=tuple(het.likelihoods_list), num_latent=Q,
                      num_inducing=args.m, input_dim=Dx, dtype="float32",
                      jitter=1e-6, adaptive_jitter=False)
    tc = TrainConfig(optimizer="adam", step_rate=0.01)
    Z = rng.rand(args.m, Dx).astype(np.float32)
    params = init_params(np.random.default_rng(0), cfg, Z, W=W,
                         lengthscale=0.3, variance=0.5, q_mu_scale=0.1,
                         device=args.device)
    batch = min(512, min(len(X1), len(X2)))
    params, hist = train_mod.svi_fit_on_device(
        params, cfg, tc, [X1, X2], [Y1, Y2], batch, args.steps,
        generator=torch.Generator().manual_seed(1),
        steps_per_call=min(100, args.steps))
    print(f"ELBO: {hist[0]:.0f} -> {hist[-1]:.0f} over {args.steps} steps")

    if args.data is not None:
        # a table: the in-sample NLPD per task (no true latents to score)
        nlpd = predict_mod.negative_log_predictive(
            params, cfg, torch.Generator().manual_seed(4), [X1, X2],
            [Y1, Y2], num_samples=200)
        print(f"in-sample NLPD: {float(nlpd):.3f}")
        return float(nlpd)

    # held-out class agreement through the latent posterior means (the
    # reference's predictive renormalizes over K-1 classes, which makes the
    # implied class-K probability uninformative)
    Xtest = rng.rand(2000, Dx)
    Utest = np.stack([latent(Xtest, q) for q in range(Q)], axis=1)
    true_logits = np.concatenate([Utest @ W[:, 2:4], np.zeros((2000, 1))], 1)
    moments = predict_mod.predict_f_all(params, cfg, [Xtest, Xtest])
    m_F2 = moments[1][0].cpu().numpy()  # (N, 2) latent means of 2 logits
    pred_logits = np.concatenate([m_F2, np.zeros((2000, 1))], axis=1)
    acc = float((np.argmax(pred_logits, 1)
                 == np.argmax(true_logits, 1)).mean())
    print(f"categorical argmax agreement with true latent field: {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()
