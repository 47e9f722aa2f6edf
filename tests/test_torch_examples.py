"""The port's examples (``hetmogp_tpu_torch/examples/``) end to end at a
small size on the CPU, as ``tests/test_demo_integration.py`` drives the
JAX package's workload: each runs its ``main`` with ``--device cpu`` and
is held to what it is for (a rising ELBO, an exact resume, probabilities
in (0, 1), a finite NLPD), not to pixels.  ``spatial`` reads the
repository's CSV sample and an npz table made here: nothing is fetched."""

from pathlib import Path

import numpy as np
import pytest
import torch

from hetmogp_tpu_torch.examples import (counts, demo, large_scale,
                                        model_parallel, optimizers,
                                        production_training, spatial,
                                        survival)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_production_training(tmp_path, capsys):
    production_training.main(["--device", "cpu", "--steps", "100", "--n",
                              "200", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "checkpoints kept: ['step_100', 'step_50']" in out
    assert "hetmogp::rbf_K_batched" in out
    assert (tmp_path / "predictive.pt2").stat().st_size > 0
    assert (tmp_path / "model.npz").exists()


def test_demo_fills_the_gap():
    nlpd = demo.main(["--device", "cpu", "--inner", "5"])
    assert np.isfinite(nlpd) and 0.0 < nlpd < 1.0


def test_optimizers_all_rise():
    results = optimizers.main(["--device", "cpu", "--steps", "30"])
    assert set(results) == {"adam", "adadelta (reference default)",
                            "natgrad_adam"}
    for hist, full in results.values():
        assert np.isfinite(full) and hist[-5:].mean() > hist[:5].mean()


@pytest.mark.parametrize("natgrad", [False, True])
def test_large_scale_small(natgrad):
    argv = ["--device", "cpu", "--steps", "10", "--warmup", "10", "--n",
            "1200", "--m", "16", "--batch", "32"]
    hist = large_scale.main(argv + ["--natgrad"] * natgrad)
    assert hist.shape == (10,) and np.isfinite(hist).all()


def test_counts_small():
    hist = counts.main(["--device", "cpu", "--steps", "10", "--warmup", "10",
                        "--n", "900", "--m", "16"])
    assert hist.shape == (10,) and np.isfinite(hist).all()


def test_survival_learns_the_shape():
    e0, e1, k = survival.main(["--device", "cpu", "--steps", "30", "--n",
                               "160"])
    assert e1 > e0 and np.isfinite(k) and k > 0


def test_spatial_synthetic_and_tables(tmp_path):
    acc = spatial.main(["--device", "cpu", "--steps", "10", "--n", "600",
                        "--m", "8"])
    assert 0.0 <= acc <= 1.0
    csv = ROOT / "examples" / "data" / "spatial_sample.csv"
    assert np.isfinite(spatial.main(["--device", "cpu", "--steps", "10",
                                     "--data", str(csv)]))
    rng = np.random.RandomState(0)
    np.savez(tmp_path / "t.npz", X0=rng.rand(30, 2), Y0=rng.randn(30),
             X1=rng.rand(20, 2), Y1=rng.randint(1, 4, 20) * 1.0)
    assert np.isfinite(spatial.main(["--device", "cpu", "--steps", "10",
                                     "--data", str(tmp_path / "t.npz")]))


def test_model_parallel_four_gloo_ranks():
    hist = model_parallel.main(["--spawn", "4", "--device", "cpu", "--steps",
                                "30", "--n", "1200", "--m", "16", "--batch",
                                "32"])
    assert hist.shape == (60,) and np.isfinite(hist).all()
    assert hist[-10:].mean() > hist[:10].mean()
