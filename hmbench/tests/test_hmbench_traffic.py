"""The traffic is made from the seed: the same seed gives the same inputs,
another seed others, and every seed sends the same set of sizes."""

from __future__ import annotations

import json
from collections import Counter

import torch

from conftest import ROOT
from hmbench import inputs
from hmbench.kinds import serve_closed, train


def _cfg(name):
    return json.loads((ROOT / "hmbench" / "configs" / f"{name}.json").read_text())


def _mix(name):
    return json.loads((ROOT / "hmbench" / "traffic" / f"{name}.json").read_text())


def _small(cfg):
    return dict(cfg, num_inducing=8, rows_per_task=3000)


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    for name in ("lmc6_m1024", "fam10_m1024"):
        cfg = _small(_cfg(name))
        draws = []
        for seed in (2 ** 31 + 5, 2 ** 31 + 5, 7):
            g = inputs.generator(seed, "cpu")
            p, data = inputs.init_params(cfg, g, "cpu"), inputs.task_data(cfg, g, "cpu")
            draws.append(torch.cat([p["Z"].flatten(), p["W"].flatten()]
                                   + [torch.cat([x.flatten(), y.flatten()]) for x, y in data]))
        assert torch.equal(draws[0], draws[1])
        assert not torch.equal(draws[0], draws[2])
        assert all(torch.isfinite(d).all() for d in draws)


def test_train_offsets_repeat_and_the_checked_rows_all_differ():
    cfg, mix = _small(_cfg("lmc6_m1024")), _mix("train_calls")
    a = train.prepare(cfg, mix, 2 ** 31 + 9, "cpu")
    b = train.prepare(cfg, mix, 2 ** 31 + 9, "cpu")
    c = train.prepare(cfg, mix, 3, "cpu")
    assert all((x == y).all() for x, y in zip(a.offsets, b.offsets))
    assert any((x != y).any() for x, y in zip(a.offsets, c.offsets))
    B = cfg["train"]["batch_per_task"]
    for t in range(a.T):  # each step's block of rows lies in its own third
        starts = sorted(int(o[t]) for o in a.offsets)
        assert all(s1 >= s0 + B for s0, s1 in zip(starts, starts[1:]))
    assert a.kinds == ["ve", "vm", "ve"]


def test_the_request_schedule_repeats_and_each_block_holds_every_pair():
    mix = _mix("serve_sizes")
    pairs = len(mix["sizes"]) * 6

    def stream(seed, n):
        s = serve_closed.Schedule(seed, 6, mix["sizes"], mix["pool_rows"], mix["keep_one_in"])
        return [next(s) for _ in range(n)]

    a, b, c = stream(2 ** 31 + 1, 3 * pairs), stream(2 ** 31 + 1, 3 * pairs), stream(4, 3 * pairs)
    assert a == b and a != c
    for block in range(3):
        got = Counter((t, r) for t, r, _, _ in a[block * pairs:(block + 1) * pairs])
        assert got == Counter({(t, s): 1 for s in mix["sizes"] for t in range(6)})
        other = Counter((t, r) for t, r, _, _ in c[block * pairs:(block + 1) * pairs])
        assert other == got  # every seed sends the same work, in another order
    largest = max(mix["sizes"])
    kept = {t for t, r, _, k in a if k and r == largest}
    assert kept == set(range(6))  # the largest request of each task is kept
    assert all(0 <= o <= mix["pool_rows"] - r for _, r, o, _ in a)
