"""The rest of the port's ``data.py`` against the JAX package's, on the
CPU: ``init_z_kmeans``, ``true_u_functions``, ``generate_toy_U``,
``true_f_functions`` and ``load_spatial_table`` are numpy code in both
packages, so from the same seed and file they give the same arrays, bit
for bit; the loader reads the repository's own CSV sample and an npz made
here, and refuses the same malformed tables."""

from pathlib import Path

import numpy as np
import pytest

from hetmogp_tpu import data as jdata
from hetmogp_tpu_torch import data as tdata

ROOT = Path(__file__).resolve().parent.parent
CSV = ROOT / "examples" / "data" / "spatial_sample.csv"


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [40, 60_000])  # the second subsamples
def test_init_z_kmeans_is_the_jax_one(n):
    rng = np.random.RandomState(0)
    X = [rng.rand(n // 2, 2), rng.rand(n - n // 2, 2)]
    got = tdata.init_z_kmeans(X, 7, seed=3, iters=5)
    np.testing.assert_array_equal(got, jdata.init_z_kmeans(X, 7, seed=3,
                                                           iters=5))
    assert got.shape == (7, 2)


def test_toy_generators_are_the_jax_ones():
    rng = np.random.RandomState(1)
    X = [np.sort(rng.rand(30, 1), 0), np.sort(rng.rand(20, 1), 0)]
    U = tdata.true_u_functions(X, 3, seed=2)
    _equal(U, jdata.true_u_functions(X, 3, seed=2))
    W = rng.randn(3, 4)
    f_index, d_index = [0, 0, 1, 1], [0, 1, 0, 1]
    _equal(tdata.true_f_functions(U, W, f_index, d_index),
           jdata.true_f_functions(U, W, f_index, d_index))
    np.testing.assert_array_equal(tdata.generate_toy_U(X[0], 3, seed=4),
                                  jdata.generate_toy_U(X[0], 3, seed=4))


def test_load_spatial_table_reads_the_repository_csv():
    got, want = tdata.load_spatial_table(CSV), jdata.load_spatial_table(CSV)
    for a, b in zip(got, want):
        _equal(a, b)
    X, Y = got
    assert all(x.shape[1] == 2 for x in X) and all(y.shape[1] == 1 for y in Y)


def test_load_spatial_table_npz_and_errors(tmp_path):
    rng = np.random.RandomState(5)
    arrays = {"X0": rng.rand(6, 3), "Y0": rng.rand(6),
              "X1": rng.rand(4, 3), "Y1": rng.rand(4, 2)}
    np.savez(tmp_path / "t.npz", **arrays)
    X, Y = tdata.load_spatial_table(tmp_path / "t.npz")
    for a, b in zip(X + Y, jdata.load_spatial_table(tmp_path / "t.npz")[0]
                    + jdata.load_spatial_table(tmp_path / "t.npz")[1]):
        np.testing.assert_array_equal(a, b)
    assert Y[0].shape == (6, 1) and Y[1].shape == (4, 2)
    np.savez(tmp_path / "gap.npz", X0=arrays["X0"], Y0=arrays["Y0"],
             X2=arrays["X1"], Y2=arrays["Y1"])
    with pytest.raises(ValueError, match="contiguous"):
        tdata.load_spatial_table(tmp_path / "gap.npz")
    (tmp_path / "bad.csv").write_text("a,b\n1,2\n")
    with pytest.raises(ValueError, match="x1..x<Dx>, task, y"):
        tdata.load_spatial_table(tmp_path / "bad.csv")
