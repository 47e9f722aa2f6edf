"""End-to-end production training workflow on the port.

The lifecycle a deployed training job needs, on one page:

1. build the model (``SVMOGP``);
2. train with the graphed on-device loop, periodic npz checkpoints and
   keep-last rotation (``fit_svi_on_device(checkpoint_dir=...)``);
3. crash-resume: rerunning the same call with ``resume=True`` restores the
   newest checkpoint and continues the exact step and minibatch stream;
4. persist the whole model (``SVMOGP.save`` / ``SVMOGP.load``);
5. export the serving predictive with ``torch.export``
   (``export.export_predictive``), loadable without the training code.

Run:  python -m hetmogp_tpu_torch.examples.production_training --device cuda
"""

import argparse
import pathlib
import tempfile

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--steps", type=int, default=200,
                    help="total optimizer steps (floored at 100 so the "
                         "crash-at-half + resume demo stays meaningful)")
    ap.add_argument("--n", type=int, default=2000, help="rows per task")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint and artifact directory (default: tmp)")
    args = ap.parse_args(argv)
    workdir = pathlib.Path(args.workdir or tempfile.mkdtemp(prefix="hetmogp_"))

    from hetmogp_tpu_torch import (SVMOGP, Bernoulli, HetGaussian,
                                   ModelConfig, Poisson, TrainConfig, export)

    # ---- data + model ----------------------------------------------------
    rng = np.random.RandomState(0)
    N = args.n
    X = [np.sort(rng.rand(N, 1), 0) for _ in range(3)]
    Y = [rng.randn(N, 1), (rng.rand(N, 1) > 0.5).astype(float),
         rng.poisson(2.0, (N, 1)).astype(float)]
    cfg = ModelConfig(likelihoods=(HetGaussian(), Bernoulli(), Poisson()),
                      num_latent=3, num_inducing=32, input_dim=1,
                      dtype="float32", jitter=1e-5, adaptive_jitter=False,
                      fuse_task_rows=True)

    def new_model():
        return SVMOGP(cfg, X, Y, np.linspace(0, 1, 32)[:, None], seed=0,
                      lengthscale=0.15, device=args.device)

    model = new_model()
    print(f"initial ELBO: {model.log_likelihood():.1f}")

    # ---- train with periodic checkpoints + exact resume ------------------
    # A killed job rerun with the same arguments restores the newest
    # step_<n> checkpoint and continues the exact step and minibatch
    # stream; the warmup-cosine schedule's count lives in adam's state,
    # so it resumes exactly too.
    args.steps = max(args.steps, 100)
    tc = TrainConfig(optimizer="adam", step_rate=0.01, minibatch="slice",
                     lr_schedule="warmup_cosine",
                     lr_schedule_kwargs=(("warmup_steps", 20),
                                         ("decay_steps", args.steps)),
                     clip_grad_norm=100.0)
    ckdir = workdir / "ckpts"
    half = (args.steps // 2) // 50 * 50
    model.fit_svi_on_device(batch_size=256, num_steps=half, steps_per_call=50,
                            train_config=tc, checkpoint_dir=ckdir,
                            keep_last=2)          # "the job dies here"
    model2 = new_model()
    model2.fit_svi_on_device(batch_size=256, num_steps=args.steps,
                             steps_per_call=50, train_config=tc,
                             checkpoint_dir=ckdir, keep_last=2, resume=True)
    kept = sorted(p.name for p in ckdir.iterdir())
    print(f"trained {args.steps} steps (resumed at {half}); "
          f"ELBO: {model2.log_likelihood():.1f}; checkpoints kept: {kept}")

    # ---- whole-model persistence -----------------------------------------
    model2.save(workdir / "model")
    served = SVMOGP.load(workdir / "model", X, Y, device=args.device)
    assert served.log_likelihood() == model2.log_likelihood()

    # ---- exported serving predictive -------------------------------------
    Xnew = [torch.linspace(0, 1, 256, device=args.device)[:, None]] * 3
    blob = export.export_predictive(served.params, served.pred_config, Xnew)
    (workdir / "predictive.pt2").write_bytes(blob)
    fn = export.load_predictive(blob)
    out = fn(*export.params_args(served.params), *Xnew)
    mp1 = out[2].detach().cpu().numpy()  # flat (m0, v0, m1, ...): Bernoulli
    assert 0.0 < mp1.min() and mp1.max() < 1.0
    print(f"exported serving predictive: {len(blob)} bytes, operators "
          f"{sorted(k for k in export.exported_ops(blob) if 'hetmogp' in k)}"
          f"; mean p(y=1) = {float(mp1.mean()):.3f}")
    print(f"artifacts in {workdir}")


if __name__ == "__main__":
    main()
