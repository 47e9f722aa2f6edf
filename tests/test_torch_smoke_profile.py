"""chip_smoke.py's check of a profiled trainer call against the launches of
its graph replays (``profile_replays``), on the CPU with a stand-in trace:
a trace that lost records is taken again, one with more calls than
launches fails at once, and the check fails unless one of PROFILE_TRIES
traces holds every kernel's calls exactly."""

from __future__ import annotations

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 50  # replays of the stand-in graph a call


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Run:
    """A trainer's bookkeeping: one graph that launches kernel 7 once,
    replayed STEPS times a call."""

    def __init__(self, smoke):
        launchers = {k for ls in smoke._SYMBOLS.values() for k in ls}
        self.capture_launches = {"ve": dict.fromkeys(launchers, 0)}
        self.capture_launches["ve"]["adam_update"] = 1
        self.replays = {"ve": 0}

    def __call__(self):
        self.replays["ve"] += STEPS


@pytest.mark.parametrize("seen, traces, error", [
    ((50,), 1, None),
    ((49, 50), 2, None),
    ((48, 49, 50), 3, None),
    ((48, 49, 47, 50), 4, None),
    ((48, 49, 47, 49), 4,
     "fewer calls than the replays launched in each of 4"),
    ((51,), 1, "the profile shows 51 calls of adam_kernel, the replays 50"),
    ((49, 51), 2, "the profile shows 51 calls of adam_kernel"),
], ids=["whole", "one_lost", "two_lost", "three_lost", "all_lost", "more",
        "lost_then_more"])
def test_profile_replays_retakes_only_a_trace_that_lost_records(
        smoke, monkeypatch, seen, traces, error):
    assert smoke.PROFILE_TRIES == 4
    run, taken = _Run(smoke), []

    def profile(call, what, smi):
        call()
        taken.append(seen[len(taken)])
        return {"adam_kernel(AdamLeaves, float const*, int)":
                (0.05 * taken[-1], taken[-1])}

    monkeypatch.setattr(smoke, "profile", profile)
    if error is None:
        smoke.profile_replays(run, run, "stand-in", "card")
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.profile_replays(run, run, "stand-in", "card")
    assert len(taken) == traces
    assert run.replays["ve"] == STEPS * traces
