"""Survival and reliability workload with the duration families, on the
port.

Two correlated failure signals over a 1-D covariate (normalized operating
stress), sharing Q latent GPs through the LMC mixing:

  task 1  time-to-failure   Weibull(k, learn_k=True): the true shape
                            k*=1.8 (wear-out) is not given to the model,
                            which starts at the Exponential k=1 and learns
                            log k as a likelihood parameter (theta)
  task 2  incident counts   ZeroInflatedPoisson: two latent parameter
                            functions (rate + inflation)

The SVMOGP lifecycle: construct -> fit_svi(learn_lik_params=True) ->
learned-shape readout -> held-out NLPD.

Run:  python -m hetmogp_tpu_torch.examples.survival --device cuda
      [--steps 400]
"""

import argparse

import numpy as np
import torch

TRUE_K = 1.8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--n", type=int, default=800)
    args = ap.parse_args(argv)

    from hetmogp_tpu_torch import (SVMOGP, HetLikelihood, ModelConfig,
                                   TrainConfig, Weibull, ZeroInflatedPoisson)
    from hetmogp_tpu_torch.data import true_f_functions, true_u_functions
    from hetmogp_tpu_torch.models.params import random_W

    rng = np.random.RandomState(0)
    Q, n = 2, args.n
    X1 = np.sort(rng.rand(n, 1), 0)
    X2 = np.sort(rng.rand(n, 1), 0)

    # ground truth: shared smooth latents mixed into 3 output functions
    # (Weibull uses 1, ZIP uses 2: rate + inflation)
    truth = HetLikelihood([Weibull(k=TRUE_K), ZeroInflatedPoisson()])
    md = truth.generate_metadata()
    W = random_W(np.random.default_rng(3), Q, truth.num_output_functions())
    U = true_u_functions([X1, X2], Q, seed=1)
    F = true_f_functions(U, W, md["function_index"], md["d_index"])
    Y1, Y2 = (y.numpy() for y in truth.samples(
        torch.Generator().manual_seed(7), [0.6 * f for f in F]))
    print(f"time-to-failure: median {np.median(Y1):.3f}; "
          f"counts: {np.mean(Y2 == 0):.0%} zeros, max {Y2.max():.0f}")

    # hold out the top stress quartile of the duration task
    cut = int(0.75 * n)
    cfg = ModelConfig(
        likelihoods=(Weibull(k=1.0, learn_k=True), ZeroInflatedPoisson()),
        num_latent=Q, num_inducing=16, input_dim=1, dtype="float32")
    model = SVMOGP(cfg, [X1[:cut], X2], [Y1[:cut], Y2],
                   np.linspace(0, 1, 16)[:, None], seed=0, lengthscale=0.2,
                   variance=0.5, device=args.device)
    e0 = model.log_likelihood()
    model.fit_svi(batch_size=256, num_steps=args.steps,
                  train_config=TrainConfig(optimizer="adam", step_rate=0.02,
                                           learn_lik_params=True))
    e1 = model.log_likelihood()
    print(f"ELBO: {e0:.0f} -> {e1:.0f} over {args.steps} steps")

    k_learned = float(torch.exp(model.params.lik_theta[0][0]))
    print(f"Weibull shape: init 1.0, learned {k_learned:.2f}, true {TRUE_K}")

    nlpd = model.negative_log_predictive([X1[cut:]], [Y1[cut:]],
                                         num_samples=500, tasks=[0])
    print(f"held-out duration NLPD (top stress quartile): {nlpd:.3f}")

    mp, vp = model.predictive([X1, X2])
    assert all(bool(torch.isfinite(m).all()) for m in mp)
    assert all(bool((v >= -1e-9).all()) for v in vp)
    print("predictive means/variances finite on both tasks")
    return e0, e1, k_learned


if __name__ == "__main__":
    main()
