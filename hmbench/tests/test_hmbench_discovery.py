"""A configuration, a traffic mix, a cell and a per-layer metric are found
by name: files dropped into a copy of the benchmark and entries added to
its BENCHMARK.json run with no file of the harness edited."""

from __future__ import annotations

import json
import shutil

from hmbench import run


def _add_dummy(root):
    h = root / "hmbench"
    cfg = json.loads((h / "configs" / "lmc6_m1024.json").read_text())
    cfg["likelihoods"] = [cfg["likelihoods"][0], cfg["likelihoods"][3]]
    (h / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((h / "traffic" / "train_calls.json").read_text())
    (h / "traffic" / "dummy_mix.json").write_text(json.dumps(dict(mix, steps_per_call=3)))
    shutil.copy(h / "limits" / "lmc6-train.json", h / "limits" / "dummy-cell.json")
    (h / "layer_metrics" / "dummy.count.py").write_text(
        "def read(layer):\n    return 42.0 if layer.get('kind') == 'train' else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "a test",
                             "file": "hmbench/configs/dummy_cfg.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_steps_per_s":
            m["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "dummy.count", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "train_steps_per_s", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_and_entries_are_found_by_name(tiny_root):
    _add_dummy(tiny_root)
    out = run.execute("dummy-cell", 2 ** 31 + 77, 0.3, False, device="cpu", root=tiny_root)
    assert out["correct"] and set(out["metrics"]) == {"train_steps_per_s", "setup_s"}
    out = run.execute("dummy-cell", 2 ** 31 + 78, 0.3, True, device="cpu", root=tiny_root)
    assert out["correct"]
    assert out["metrics"] == {"dummy.count": {"value": 42.0, "unit": "count"}}
    assert list(out)[-1] == "checks"
