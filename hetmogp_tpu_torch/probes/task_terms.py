"""Kernel 6's task table on its multi-term families, on the card.

    python3 -m hetmogp_tpu_torch.probes.task_terms [--parent DIR]

The task table (``csrc/ve_tasks_kernel.cu``) takes Beta, Binomial,
Dirichlet (K = 2, 3) and the zero-inflated Poisson: several sweeps a row,
each on its own node table, and a family's constants.  This probe:

* checks each family's rows (value, c_m, c_v) from the forward launch at
  the ten-family model's VE batch (512 rows, then the extreme moments of
  ``tests/test_torch_task_var_exp.py``), against the plain var_exp in
  float64 on the CPU: float32 within 4x the plain float32 var_exp's error
  + 1e-6 and non-finite exactly where it is; float64 within 1e-12 (c_v of
  the lngamma sweeps 1e-8: torch's trigamma); two launches, and the value
  alone, bitwise equal; then the ten-family table of four tasks in one
  launch against the plain term's sums and gradients;
* times the four tasks' forward and backward launches at the VE and VM
  batches, eager and as a replayed CUDA graph (CUDA events behind a device
  sleep), beside the empty kernel;
* prints ptxas's registers, spills and shared memory of every
  instantiation of ``ve_tasks_kernel`` from the build's log, and with
  ``--parent DIR`` those of DIR's ``csrc/ve_tasks_kernel.cu`` compiled with
  the same flags, for the flagship's instantiations before and after.

Prints the card's name and power limit beside every number.  A measurement
script run by hand from a checkout: the packaging leaves this directory
out of an installed ``hetmogp_tpu_torch``.  Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# m = -+200 with v = 50, m = -+20 with v = 5, and v = 0
EXTREME_MV = ((-200.0, 50.0), (200.0, 50.0), (-20.0, 5.0), (20.0, 5.0),
              (0.3, 0.0), (-1.5, 0.0))
TRIGAMMA = ("Beta", "Dirichlet-K2", "Dirichlet-K3")


def families():
    from hetmogp_tpu_torch import likelihoods as tliks

    return {
        "Beta": (tliks.Beta(), lambda r, n: 0.02 + 0.96 * r.rand(n, 1)),
        "Binomial-n1": (tliks.Binomial(n=1),
                        lambda r, n: r.randint(0, 2, (n, 1)) * 1.0),
        "Binomial-n10": (tliks.Binomial(n=10),
                         lambda r, n: r.randint(0, 11, (n, 1)) * 1.0),
        "Dirichlet-K2": (tliks.Dirichlet(K=2),
                         lambda r, n: r.dirichlet([2.0, 3.0], n)),
        "Dirichlet-K3": (tliks.Dirichlet(K=3),
                         lambda r, n: r.dirichlet([2.0, 3.0, 1.5], n)),
        "ZIP-y0": (tliks.ZeroInflatedPoisson(),
                   lambda r, n: np.zeros((n, 1))),
        "ZIP": (tliks.ZeroInflatedPoisson(),
                lambda r, n: r.poisson(3.0, (n, 1)) + 1.0),
    }


def inputs(lik, draw, n, seed):
    """(Y, m, v) float64 numpy: n random rows, then the extreme ones."""
    rng = np.random.RandomState(seed)
    J = lik.dim_f
    m = np.concatenate([1.5 * rng.randn(n, J),
                        np.repeat([[a] for a, _ in EXTREME_MV], J, 1)])
    v = np.concatenate([0.01 + 2.0 * rng.rand(n, J),
                        np.repeat([[b] for _, b in EXTREME_MV], J, 1)])
    return draw(rng, n + len(EXTREME_MV)), m, v


def plain(lik, Y, m, v, dtype, device="cpu"):
    """(value, c_m, c_v) of the plain var_exp, as float64 numpy."""
    M = torch.tensor(m, dtype=dtype, device=device, requires_grad=True)
    V = torch.tensor(v, dtype=dtype, device=device, requires_grad=True)
    val = lik.var_exp(torch.tensor(Y, dtype=dtype, device=device), M, V,
                      use_kernel=False)
    dm, dv = torch.autograd.grad(val.sum(), (M, V))
    return [a.detach().double().cpu().numpy() for a in (val, dm, dv)]


def table_rows(liks, Ys, ms, vs, dtype, deriv=True):
    """Each task's (value, c_m, c_v) from one forward launch (c_m, c_v
    None for the value alone), as tensors on the card."""
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.ops import quadrature

    dev = torch.device("cuda")
    Y = [torch.tensor(a, dtype=dtype, device=dev) for a in Ys]
    M = [torch.tensor(a, dtype=dtype, device=dev) for a in ms]
    V = [torch.tensor(a, dtype=dtype, device=dev) for a in vs]
    masks = [torch.ones(a.shape[0], dtype=dtype, device=dev) for a in ms]
    scales = [torch.ones((), dtype=dtype, device=dev) for _ in ms]
    tasks, sc = quadrature._task_launch_args(liks, Y, M, V, masks, scales)
    if not deriv:
        return ck.task_var_exp_value(tasks, sc)[1], None
    _, values, coefs = ck.task_var_exp(tasks, sc)
    return values, coefs


def normwise(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def check_phase(smi: str) -> None:
    for name, (lik, draw) in families().items():
        J = lik.dim_f
        Y, m, v = inputs(lik, draw, 512, 11)
        # float32: the inputs rounded once, the references on those values
        Y32, m32, v32 = (a.astype(np.float32) for a in (Y, m, v))
        want = plain(lik, *(a.astype(np.float64) for a in (Y32, m32, v32)),
                     torch.float64)
        p32 = plain(lik, Y32, m32, v32, torch.float32, "cuda")
        vals, coefs = table_rows([lik], [Y32], [m32], [v32], torch.float32)
        again = table_rows([lik], [Y32], [m32], [v32], torch.float32)
        alone, _ = table_rows([lik], [Y32], [m32], [v32], torch.float32,
                              deriv=False)
        bitwise = (torch.equal(vals[0], again[0][0])
                   and torch.equal(coefs[0], again[1][0]))
        same_value = torch.equal(vals[0], alone[0])
        off = int((vals[0] != alone[0]).sum())
        diff = float((vals[0] - alone[0]).abs().max())
        c = coefs[0].double().cpu().numpy()
        got = [vals[0].double().cpu().numpy(), c[:, :J], c[:, J:]]
        parts = []
        ok = bitwise and same_value
        for what, a, p, b in zip(("value", "c_m", "c_v"), got, p32, want):
            same = bool((np.isfinite(a) == np.isfinite(p)).all())
            fin = np.isfinite(p) & np.isfinite(b)
            err, bound = normwise(a[fin], b[fin]), \
                4.0 * normwise(p[fin], b[fin]) + 1e-6
            ok &= same and err <= bound
            parts.append(f"{what} {err:.3e} (bound {bound:.3e}, finite as "
                         f"plain: {same})")
        # float64 against the plain float64 var_exp
        want64 = plain(lik, Y, m, v, torch.float64)
        vals64, coefs64 = table_rows([lik], [Y], [m], [v], torch.float64)
        c64 = coefs64[0].cpu().numpy()
        for what, a, b in zip(("value", "c_m", "c_v"),
                              [vals64[0].cpu().numpy(), c64[:, :J],
                               c64[:, J:]], want64):
            fin = np.isfinite(b)
            err = normwise(a[fin], b[fin])
            tol = 1e-8 if (name in TRIGAMMA and what == "c_v") else 1e-12
            ok &= bool((np.isfinite(a) == fin).all()) and err < tol
            parts.append(f"f64 {what} {err:.3e} ({tol:g})")
        print(f"task table, {name} ({m.shape[0]} rows, float32 vs plain "
              f"float64): {'; '.join(parts)}; two launches bitwise: "
              f"{bitwise}; the value alone bitwise the derivative launch's:"
              f" {same_value} ({off} rows differ, by at most {diff:.3e}) "
              f"[card: {smi}]")
        if not ok:
            raise AssertionError(f"the task table's {name} rows are off")
    # the ten-family table's four tasks in one launch, the term's sums and
    # gradients against the plain term's
    from hetmogp_tpu_torch.ops import quadrature

    fam = families()
    names = ("Beta", "Binomial-n10", "Dirichlet-K3", "ZIP")
    liks = [fam[n][0] for n in names]
    rng = np.random.RandomState(12)
    args64 = []
    for i, (n_, lik) in enumerate(zip(names, liks)):
        Y, m, v = inputs(lik, fam[n_][1], 512, 13 + i)
        mask = (rng.rand(m.shape[0]) > 0.2) * 1.0
        args64.append((Y, m, v, mask))
    scales = 1.0 + 10.0 * rng.rand(len(names))
    sums = {}
    for dtype, device, use in ((torch.float32, "cuda", True),
                               (torch.float32, "cuda", False),
                               (torch.float64, "cpu", False)):
        M = [torch.tensor(a[1], dtype=dtype, device=device,
                          requires_grad=True) for a in args64]
        V = [torch.tensor(a[2], dtype=dtype, device=device,
                          requires_grad=True) for a in args64]
        conv = [[torch.tensor(a[k], dtype=dtype, device=device)
                 for a in args64] for k in (0, 3)]
        sc = list(torch.tensor(scales, dtype=dtype, device=device))
        s = quadrature.task_var_exp(liks, conv[0], M, V, conv[1], sc,
                                    use_kernel=use)
        g = torch.autograd.grad(s.sum(), M + V)
        sums[dtype, use] = [s.detach().double().cpu().numpy()] + [
            a.double().cpu().numpy() for a in g]
    ref = sums[torch.float64, False]
    table, p32 = sums[torch.float32, True], sums[torch.float32, False]
    errs = [(normwise(a, r), 4.0 * normwise(p, r) + 1e-6)
            for a, p, r in zip(table, p32, ref)]
    print(f"task table, the ten-family table (Beta, Binomial n=10, "
          f"Dirichlet K=3, ZIP; 518 rows each, masked, scaled) in one "
          f"launch each way: sums {errs[0][0]:.3e} (bound {errs[0][1]:.3e}),"
          f" dM, dV at most {max(e / b for e, b in errs[1:]):.3f} of their "
          f"bounds [card: {smi}]")
    if any(e > b for e, b in errs):
        raise AssertionError("the ten-family table's term is off")


def time_phase(smi: str) -> None:
    """The ten-family table's forward and backward launches, eager and
    graphed, at the VE (4 x 512) and VM (4 x 128) batches."""
    from hetmogp_tpu_torch import profiling
    from hetmogp_tpu_torch.ops import cuda_kernels as ck
    from hetmogp_tpu_torch.ops import quadrature

    fam = families()
    names = ("Beta", "Binomial-n10", "Dirichlet-K3", "ZIP")
    liks = [fam[n][0] for n in names]
    empty = statistics.median(profiling.device_times_ms(ck.empty_launch,
                                                        reps=40))
    for label, rows in (("VE", 512), ("VM", 128)):
        rng = np.random.RandomState(14)
        Ys = [fam[n][1](rng, rows) for n in names]
        ms = [1.5 * rng.randn(rows, lik.dim_f) for lik in liks]
        vs = [0.01 + 2.0 * rng.rand(rows, lik.dim_f) for lik in liks]
        dev = torch.device("cuda")
        Y = [torch.tensor(a, dtype=torch.float32, device=dev) for a in Ys]
        M = [torch.tensor(a, dtype=torch.float32, device=dev,
                          requires_grad=True) for a in ms]
        V = [torch.tensor(a, dtype=torch.float32, device=dev,
                          requires_grad=True) for a in vs]
        masks = [torch.ones(rows, device=dev) for _ in liks]
        sc = [torch.ones((), device=dev) for _ in liks]

        def term():
            s = quadrature.task_var_exp(liks, Y, M, V, masks, sc)
            torch.autograd.grad(s.sum(), M + V)

        tasks, scd = quadrature._task_launch_args(liks, Y, M, V, masks, sc)
        _, _, coefs = ck.task_var_exp(tasks, scd)
        g = torch.ones(len(liks), device=dev)
        fns = {"forward": lambda: ck.task_var_exp(tasks, scd),
               "value": lambda: ck.task_var_exp_value(tasks, scd),
               "backward": lambda: ck.task_var_exp_backward(
                   coefs, [t[4] for t in tasks], scd, g),
               "term": term}
        t = {k: statistics.median(profiling.device_times_ms(f, reps=40))
             for k, f in fns.items()}
        graph = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            term()
            torch.cuda.synchronize()
            with torch.cuda.graph(graph):
                term()
        torch.cuda.current_stream().wait_stream(s)
        graphed = statistics.median(profiling.device_times_ms(graph.replay,
                                                              reps=40))
        print(f"task table, ten-family four tasks at {label} ({len(liks)} x "
              f"{rows} rows, float32): forward {t['forward']:.4f} ms, the "
              f"value alone {t['value']:.4f}, backward {t['backward']:.4f}; "
              f"the term forward and backward {t['term']:.4f} eager, "
              f"{graphed:.4f} graphed; empty kernel {empty:.4f} ms; medians "
              f"of 40 [card: {smi}]")


def ptxas_phase(smi: str, parent: str | None) -> None:
    """ptxas -v of every instantiation of ve_tasks_kernel: the build's log,
    and DIR's source compiled with the same flags."""
    from hetmogp_tpu_torch.ops import _build

    def lines(log):
        out, name = [], None
        for line in log.splitlines():
            if "entry function" in line:
                name = line.split("'")[1] if "'" in line else line
            elif name and "ve_tasks_kernel" in name and (
                    "registers" in line or "spill" in line):
                out.append((name, line.strip()))
        return out

    log = _build.library_path().with_suffix(".log").read_text()
    for name, line in lines(log):
        print(f"ptxas, this tree, {name}: {line} [card: {smi}]")
    if parent is None:
        return
    src = Path(parent) / "hetmogp_tpu_torch" / "csrc" / "ve_tasks_kernel.cu"
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build.find_nvcc(), *flags, "-c", "-o",
                               str(Path(tmp) / "k.o"), str(src)],
                              capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    for name, line in lines(proc.stdout + proc.stderr):
        print(f"ptxas, parent, {name}: {line} [card: {smi}]")


def main() -> int:
    import chip_smoke as c

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a checkout whose ve_tasks_kernel.cu's ptxas to "
                         "print beside this tree's")
    ap.add_argument("--phases", default="ptxas,check,time")
    args = ap.parse_args()
    smi = c.device_phase()
    c.build_phase(smi)
    phases = args.phases.split(",")
    if "ptxas" in phases:
        ptxas_phase(smi, args.parent)
    if "check" in phases:
        check_phase(smi)
    if "time" in phases:
        time_phase(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
