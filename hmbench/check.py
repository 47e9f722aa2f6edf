"""The numbers that decide ``correct``, each beside its limit.

Training: the ELBO at each checked step against the reference's (the worst
relative gap); the first gradient of every leaf, as adam's first moment
holds it after the checked call of the leaf's first free step; the
parameters' change over the checked steps.  A leaf's gap is the gap
between the program's norm and the reference's, against the reference's
norm of that leaf or the median leaf's, whichever is larger, over the
leaves whose reference norm is at least a thousandth of the median
leaf's; both numbers take the worst leaf.  The change is taken over the
elements the program's gradient resolves: those whose reference gradient
lies above the program's gradient error there (a leaf where it resolves
none is taken whole).  adam moves an element whose gradient lies below
float32 round-off by about its step either way, so the change of those
elements reads the round-off of the program's smallest gradients, not its
updates (PERF.md, the look).

Serving: every kept request's served mean and variance against the
reference's, normwise (max |a - b| / max |b|), the worst request.
"""

from __future__ import annotations

import math
import sys

import torch

from hmbench.reference import svgp


def _nonempty(d: dict) -> dict:
    return {k: v for k, v in d.items() if v.numel()}


def _flat(p: dict) -> dict:
    """{leaf: tensor} with theta as lik_theta.<t>."""
    out = {k: v for k, v in p.items() if k != "lik_theta"}
    out.update({f"lik_theta.{t}": v for t, v in enumerate(p.get("lik_theta") or [])})
    return out


def first_grads(calls: list, free_vm) -> dict:
    """Each leaf's gradient at its first free step, from adam's first
    moments after each checked call.  calls: per call (the kinds of its
    steps, the moments after it).  Before its first free step a leaf's
    moment is zero; that step makes it (1 - b1) g, and each later step of
    the call in which the leaf is frozen decays it by b1.  A leaf free
    twice in one call has no first gradient in the state after it."""
    def free(kind):
        return svgp.VE_FREE if kind == "ve" else free_vm

    out = {}
    for kinds, mu in calls:
        for i, kind in enumerate(kinds):
            for name, m in mu.items():
                base = name.split(".")[0]
                if name in out or base not in free(kind):
                    continue
                later = kinds[i + 1:]
                if any(base in free(k) for k in later):
                    raise ValueError(f"{name} is free twice in one checked call")
                out[name] = m.double() / ((1.0 - svgp.B1) * svgp.B1 ** len(later))
    return out


def resolved(g_p: dict, g_r: dict) -> dict:
    """{leaf: mask} of the elements whose reference gradient lies above the
    program's gradient error (all of a leaf where none does)."""
    out = {}
    for k, r in g_r.items():
        mask = r.abs() > (g_p[k].to(r.device) - r).abs() if k in g_p else None
        out[k] = mask if mask is not None and bool(mask.any()) else torch.ones_like(
            r, dtype=torch.bool)
    return out


def train_numbers(prog: tuple, ref: tuple, p0: dict) -> dict:
    """prog, ref: (ELBOs, {leaf: first gradient}, params after) of the
    checked steps; p0: the initial params."""
    (e_p, g_p, a_p), (e_r, g_r, a_r) = prog, ref
    init, a_p, a_r = _flat(p0), _flat(a_p), _flat(a_r)
    dev = next(iter(init.values())).device
    g_p = _nonempty({k: v.to(dev) for k, v in g_p.items()})
    g_r = _nonempty({k: v.to(dev) for k, v in g_r.items()})
    mask = resolved(g_p, g_r)

    def change(after):
        return _nonempty({k: (after[k].to(dev).double() - init[k].double())[mask[k]]
                          for k in mask})

    grad, moved = svgp.leaf_gaps(g_p, g_r), svgp.leaf_gaps(change(a_p), change(a_r))
    share = {k: round(float(m.double().mean()), 4) for k, m in mask.items()}
    print(f"gaps by leaf: first gradient {grad}; change {moved}; share of each "
          f"leaf's elements resolved {share}; ELBOs {e_p} against {e_r}",
          file=sys.stderr)
    return {"loss": svgp.worst(abs(a - b) / abs(b) for a, b in zip(e_p, e_r)),
            "grad": svgp.worst(grad.values()) if grad else math.inf,
            "change": svgp.worst(moved.values()) if moved else math.inf}


def normwise(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double().to(a.device)
    scale = float(b.abs().max())
    if scale == 0.0:
        return 0.0 if float(a.abs().max()) == 0.0 else math.inf
    gap = float((a - b).abs().max()) / scale
    return gap if math.isfinite(gap) else math.inf


def serve_numbers(ref, p0, kept) -> dict:
    """kept: (task, X, mean, var) of each kept request."""
    mean, var = [], []
    for task, X, m, v in kept:
        rm, rv = ref.served(p0, X, task)
        mean.append(normwise(m, rm))
        var.append(normwise(v, rv))
    return {"mean": svgp.worst(mean), "var": svgp.worst(var)}


def beside(numbers: dict, limits: dict) -> list:
    return [(k, numbers[k], limits[k]) for k in limits]


def passed(checks) -> bool:
    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
