"""The least time of each recorded launch of the program's hand kernels,
from the launcher's name and the shapes of its arguments
(``port.record_launches``), as (least ms, device symbol, calls).

Which kernels a step or a request launches, at which shapes, is the
program's own routing: it is read from what the program launched, never
restated here.  Only the bound of a launcher at its arguments' shapes is
here, keyed by the launcher (the keys of the program's launch counters).
A launcher without an entry is left out of a share, its least time and its
device time both.
"""

from __future__ import annotations

from collections import Counter

from hmbench.roofline import kernels as k


def _rbf(symbol):
    def f(X, Z, *a, **kw):
        q, m, dx = Z
        return [(k.rbf(q, X[-2], m, dx)[0], symbol)]
    return f


def _proj(symbol, passes=1, split=False):
    def f(A, L, *a, **kw):
        q, n, m = A
        out = [(k.proj(q, n, m, passes)[0], symbol)]
        if split:
            out.append(k.split(q, m))
        return out
    return f


def _right(symbol, passes=1):
    def f(A, L, epilogue="product", *a, **kw):
        epilogue = kw.get("epilogue", epilogue)
        q, n, m = A
        out = [(k.right(q, n, m, epilogue if passes == 1 else "product", passes)[0],
                symbol)]
        if passes == 1 and epilogue != "product":
            # the entry's second launch adds the per-tile partials of the
            # row sums: its work is in the first's bound
            out.append((0.0, "row_sum_kernel"))
        return out
    return f


def _out(symbol, passes=1):
    def f(A, B, *a, **kw):
        q, n, m = A
        return [(k.out(q, n, m, passes)[0], symbol)]
    return f


def _sweep(deriv):
    def f(family, y, m, v, *a, **kw):
        (n, dy), (_, j) = y, m
        return [(k.gh_sweep(n, dy, j, deriv)[0], "gh_sweep_kernel")]
    return f


def _task(deriv):
    def f(tasks, *a, **kw):
        rows = [(m[0], y[1], m[1]) for _, y, m, *_ in tasks]
        return [(k.task_forward(rows, deriv)[0], "ve_tasks_kernel")]
    return f


def _task_backward(coefs, *a, **kw):
    return [(k.task_backward([(c[0], None, c[1] // 2) for c in coefs])[0],
             "ve_tasks_grad_kernel")]


def _adam(tensors, grads, *a, **kw):
    def size(shape):
        n = 1
        for d in shape:
            n *= d
        return n

    free = sum(size(t) for t, g in zip(tensors, grads) if g is not None)
    frozen = sum(size(t) for t, g in zip(tensors, grads) if g is None)
    return [k.adam(free, frozen)]


def _panel(A, *a, **kw):
    q, n, _ = A
    return [k.chol_panel(q, n)]


FORMULAS = {
    "rbf_K_batched_vec": _rbf("rbf_cross_vec_kernel"),
    "rbf_K_batched_scalar": _rbf("rbf_cross_kernel"),
    "tril_projection_tma": _proj("tril_proj_tma_kernel"),
    "tril_projection_staged": _proj("tril_proj_kernel"),
    "tril_projection_3pass_tma": _proj("tril_proj3_tma_kernel", 3, split=True),
    "tril_projection_3pass_staged": _proj("tril_proj3_kernel", 3),
    "tril_right_tma": _right("tril_right_tma_kernel"),
    "tril_right_generic": _right("tril_right_generic_kernel"),
    "tril_right3_tma": _right("tril_right3_tma_kernel", 3),
    "tril_right3_generic": _right("tril_right3_generic_kernel", 3),
    "tril_out_tma": _out("tril_out_tma_kernel"),
    "tril_out3_tma": _out("tril_out3_tma_kernel", 3),
    "tril_out_generic": _out("tril_out_generic_kernel"),
    "tril_out3_generic": _out("tril_out_generic_kernel", 3),
    "gh_sweep": _sweep(True),
    "gh_sweep_value": _sweep(False),
    "task_var_exp": _task(True),
    "task_var_exp_value": _task(False),
    "task_var_exp_backward": _task_backward,
    "adam_update": _adam,
    "chol_panel": _panel,
}


def entries(record: dict) -> list:
    """(least ms, symbol, calls) of one recorded launcher call; a launcher
    that launched n times (kernel 6's table and kernel 7 launch once a
    chunk of tasks or leaves) has its least time spread over its calls."""
    ents = FORMULAS[record["launcher"]](*record["args"], **record["kwargs"])
    return [(ms, sym, record["launches"]) for ms, sym in ents]


def table(records: list) -> list:
    """The entries of every recorded call with launches and a formula."""
    return [e for r in records if r["launches"] and r["launcher"] in FORMULAS
            for e in entries(r)]


def graph_tables(records: list, kinds, capture: dict):
    """{kind: entries} of each captured graph, from the launches recorded
    while a graph was being captured, in the order of ``kinds`` (the order
    the trainer captures them in), each held to the program's counters of
    that graph (``capture``: {kind: {launcher: launches}}).  None, with
    the difference, where they disagree."""
    captured = [r for r in records if r["capturing"] and r["launches"]]
    out, i = {}, 0
    for kind in kinds:
        want = Counter({n: c for n, c in capture.get(kind, {}).items()
                        if c and n != "rbf_backward"})
        got, j = Counter(), i
        while j < len(captured) and sum(got.values()) < sum(want.values()):
            got[captured[j]["launcher"]] += captured[j]["launches"]
            j += 1
        if got != want:
            return None, f"the {kind} graph's recorded launches {dict(got)} " \
                         f"and the program's counters {dict(want)} differ"
        out[kind], i = table(captured[i:j]), j
    if i != len(captured):
        return None, f"{len(captured) - i} captured launches belong to no graph"
    return out, ""
