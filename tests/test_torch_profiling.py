"""The port's ``profiling.py`` on the CPU: ``trace`` writes a Chrome trace
that holds the named regions of ``annotate`` (which nest),
``assert_finite`` names the offending leaf of a params dataclass or a
dict (the JAX package's message), ``debug_nans`` toggles autograd's
anomaly mode, and of the card's measurement helpers, the parts that need
no card: the clock samples' window and the bound."""

import datetime
import json

import numpy as np
import pytest
import torch

import hetmogp_tpu_torch as tp
from hetmogp_tpu_torch import profiling

torch.set_num_threads(1)


def test_trace_writes_a_chrome_trace_with_nested_annotations(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer",
                                                               "inner")}
    assert set(spans) == {"outer", "inner"}
    o, i = spans["outer"], spans["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def test_assert_finite_names_the_leaf():
    cfg = tp.ModelConfig(likelihoods=(tp.Gaussian(), tp.Ordinal(K=3)),
                         num_latent=2, num_inducing=4, input_dim=1,
                         dtype="float64")
    params = tp.init_params(np.random.default_rng(0), cfg,
                            np.linspace(0, 1, 4)[:, None],
                            with_lik_theta=True, device="cpu")
    profiling.assert_finite(params)
    params.lik_theta[1][0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"params\.lik_theta\[1\]: 1/2 non-finite"):
        profiling.assert_finite(params)
    bad = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, float("inf")])}}
    with pytest.raises(FloatingPointError, match=r"grads\['b'\]\['c'\]"):
        profiling.assert_finite(bad, "grads")


def test_debug_nans_toggles_anomaly_mode():
    profiling.debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).backward()
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()


def _at(stamp: str) -> float:
    return datetime.datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp()


SMI_LINES = ["2026/10/17 10:16:01.450, 1755, 120.50",
             "2026/10/17 10:16:01.500, 1980, 401.25",
             "[Not Supported], 1980, 400.00",
             "2026/10/17 10:16:02.000, 1965, 455.00",
             "2026/10/17 10:16:02.050, 1755, 130.00"]


@pytest.mark.parametrize("t0, t1, want", [
    ("2026/10/17 10:16:01.500", "2026/10/17 10:16:02.000",
     [(1980.0, 401.25), (1965.0, 455.0)]),
    ("2026/10/17 10:16:01.000", "2026/10/17 10:16:03.000",
     [(1755.0, 120.5), (1980.0, 401.25), (1965.0, 455.0), (1755.0, 130.0)]),
    ("2026/10/17 10:16:02.001", "2026/10/17 10:16:02.049", []),
])
def test_clock_samples_are_taken_by_their_timestamp(t0, t1, want):
    """``sampled_clocks`` keeps the nvidia-smi samples whose timestamp lies
    in the window of the calls, whatever their position in the output, and
    passes over lines of another form."""
    assert profiling.window_samples(SMI_LINES, _at(t0), _at(t1)) == want


def test_bound_is_the_larger_of_bytes_and_operations():
    ms, by = profiling.bound_ms(3.35e9, 1e6, profiling.F32_PEAK)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = profiling.bound_ms(8.0, 67e9, profiling.F32_PEAK)
    assert (ms, by) == (pytest.approx(1.0), "operations")
