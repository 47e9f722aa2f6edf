"""The benchmark of hetmogp_tpu_torch: one run of one cell.

    python3 -m hmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  ``BENCHMARK.json`` names the cell's configuration, traffic mix and
metrics; the mix's ``kind`` names its generator (``kinds/<kind>.py``); the
cell's limits are ``limits/<cell>.json``; each per-layer metric is read by
``layer_metrics/<name>.py``.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``), ``device``, ``breakdown`` (``--trace 1``) and ``checks``
(each number that decides ``correct`` beside its limit), and the checks
again as the last lines of standard error.  Exits non-zero, printing no
result, without CUDA or the cards the cell asks for, and when the JAX
package or JAX itself was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hetmogp_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = ROOT / "build" / "hmbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process, one host thread of compute: the window's host work is
    # the launch loop, which spinning worker threads would slow
    os.environ["OMP_NUM_THREADS"] = "1"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Spec:
    """A cell of BENCHMARK.json and the files it names, found by name."""

    def __init__(self, workload: str, root: Path = ROOT):
        self.bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                             f"{sorted(cells)}")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.cfg = json.loads((root / configs[self.cell["config"]]["file"]).read_text())
        here = root / "hmbench"
        self.mix = json.loads((here / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.limits = json.loads((here / "limits" / f"{workload}.json").read_text())
        self.here = here

    def metrics(self, group: str) -> list:
        return [m for m in self.bench[group]
                if "workloads" not in m or self.cell["name"] in m["workloads"]]

    def reader(self, name: str):
        path = self.here / "layer_metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "hmbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Context:
    """What a generator gets: the cell's files, the run's arguments and the
    device's helpers."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool, device: str):
        import torch

        self.spec, self.cfg, self.mix = spec, spec.cfg, spec.mix
        self.limits = {k: v["limit"] for k, v in spec.limits.items()}
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.cuda = torch.device(device).type == "cuda"
        self.torch = torch

    def elapsed(self) -> float:
        return time.perf_counter() - T0

    def log(self, what: str) -> None:
        print(f"[{self.elapsed():8.2f} s] {what}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def memory_peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def launch_counts(self) -> dict:
        from hmbench import port
        return port.launch_counts() if self.cuda else {}

    def take(self, call, expected):
        from hmbench import port, trace
        return trace.take(call, port.empty_launch, expected) if self.cuda else None

    def free(self) -> None:
        import gc
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def read_layers(self, res) -> None:
        """Each per-layer metric of the cell from its reader; a reader that
        finds nothing to read returns None, and the metric is left out."""
        for m in self.spec.metrics("per_layer"):
            value = self.spec.reader(m["name"])(res.layer)
            self.log(f"read {m['name']}: {value}")
            if value is None:
                print(f"per-layer metric {m['name']}: nothing to read", file=sys.stderr)
            else:
                res.per_layer[m["name"]] = float(value)


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", root: Path = ROOT) -> dict:
    """One run; returns the result's line as a dict."""
    from hmbench import check

    spec = Spec(workload, root)
    ctx = Context(spec, seed, seconds, trace, device)
    generator = importlib.import_module(f"hmbench.kinds.{spec.mix['kind']}")
    res = generator.run(ctx)
    units = {m["name"]: m["unit"] for g in ("end_to_end", "per_layer") for m in spec.bench[g]}
    if trace:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in res.per_layer.items()}
    else:
        values = dict(res.e2e, setup_s=res.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics("end_to_end")}
    dev = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": ctx.torch.cuda.get_device_name(0) if ctx.cuda else "cpu",
           "count": 1, "memory_peak_bytes": res.memory_peak_bytes}
    out = {"correct": check.passed(res.checks), "attempted": res.attempted,
           "failed": res.failed, "metrics": metrics, "device": dev}
    if trace and res.trace is not None:
        dev["busy_s"], dev["window_s"] = res.trace.busy_s, res.trace.window_s
        out["breakdown"] = res.trace.breakdown()
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in res.checks}
    return out


def card() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    torch.set_num_threads(1)
    print(f"[{time.perf_counter() - T0:8.2f} s] torch imported", file=sys.stderr)
    spec = Spec(args.workload)
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card()}", file=sys.stderr)
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    found = loaded_forbidden()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
