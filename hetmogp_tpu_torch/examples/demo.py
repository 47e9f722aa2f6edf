"""Heterogeneous multi-output GP demo: missing-gap prediction, on the port.

Two heterogeneous outputs (real-valued + binary) share two latent GPs; a
contiguous chunk of the binary task's inputs is deleted, and the model
reconstructs it through the shared latent structure.

Run:  python -m hetmogp_tpu_torch.examples.demo --device cuda [--plot]
"""

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--inner", type=int, default=40,
                    help="L-BFGS iterations per VEM half-step")
    ap.add_argument("--stochastic", action="store_true",
                    help="minibatch SVI instead of batch VEM")
    args = ap.parse_args(argv)

    from hetmogp_tpu_torch import (SVMOGP, Bernoulli, HetGaussian,
                                   HetLikelihood, ModelConfig, TrainConfig)
    from hetmogp_tpu_torch.data import true_f_functions, true_u_functions
    from hetmogp_tpu_torch.models.params import random_W

    # ---- toy data ------------------------------------------------------
    rng = np.random.RandomState(0)
    N1, N2, Q, M = 600, 500, 2, 8
    X1 = np.sort(rng.rand(N1, 1), axis=0)
    X2 = np.sort(rng.rand(N2, 1), axis=0)

    likelihood = HetLikelihood([HetGaussian(), Bernoulli()])
    md = likelihood.generate_metadata()
    D = likelihood.num_output_functions()

    W = random_W(np.random.default_rng(11), Q, D)
    U = true_u_functions([X1, X2], Q, seed=3)
    F = true_f_functions(U, 0.4 * W, md["function_index"], md["d_index"])
    Y = likelihood.samples(torch.Generator().manual_seed(5), F)
    Y1, Y2 = (y.numpy() for y in Y)

    # delete a gap from the binary task (rows 351:450)
    keep = np.r_[0:351, 450:N2]
    X2g, Y2g = X2[keep], Y2[keep]

    # ---- model ----------------------------------------------------------
    cfg = ModelConfig(likelihoods=tuple(likelihood.likelihoods_list),
                      num_latent=Q, num_inducing=M, input_dim=1,
                      dtype="float32")
    model = SVMOGP(cfg, [X1, X2g], [Y1, Y2g], np.linspace(0, 1, M)[:, None],
                   seed=0, W=W, lengthscale=0.1, variance=0.5,
                   device=args.device)
    print(f"initial ELBO: {model.log_likelihood():.2f}")

    if args.stochastic:
        model.fit_svi(batch_size=128, num_steps=args.steps,
                      train_config=TrainConfig(optimizer="adam",
                                               step_rate=0.01))
    else:
        model.fit_vem(TrainConfig(vem_iters=3, batch_inner_iters=args.inner),
                      verbose=True)
    print(f"final ELBO:   {model.log_likelihood():.2f}")

    # ---- prediction over the gap ----------------------------------------
    Xtest, Ytest = X2[351:450], Y2[351:450]
    nlpd = model.negative_log_predictive([Xtest], [Ytest], num_samples=500,
                                         tasks=[1])
    print(f"NLPD over the missing gap: {nlpd:.4f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 1, figsize=(10, 8), sharex=True)
        Xd = np.linspace(0, 1, 300)[:, None]
        mp, vp = (([t.cpu().numpy() for t in a])
                  for a in model.predictive([Xd, Xd]))
        axes[0].plot(X1, Y1, "b+", alpha=0.3)
        axes[0].plot(Xd, mp[0], "k-")
        s = np.sqrt(vp[0])
        axes[0].fill_between(Xd[:, 0], (mp[0] - 2 * s)[:, 0],
                             (mp[0] + 2 * s)[:, 0], alpha=0.2)
        axes[0].set_title("task 1: HetGaussian")
        axes[1].plot(X2g, Y2g, "b+", alpha=0.3)
        axes[1].plot(Xtest, Ytest, "r+", alpha=0.5, label="held-out gap")
        axes[1].plot(Xd, mp[1], "k-")
        axes[1].axvspan(float(X2[351, 0]), float(X2[449, 0]), alpha=0.1,
                        color="r")
        axes[1].set_title("task 2: Bernoulli p(y=1)")
        axes[1].legend()
        fig.savefig("demo_gap.png", dpi=120)
        print("wrote demo_gap.png")
    return nlpd


if __name__ == "__main__":
    main()
