"""Kernels a step that are neither the port's hand kernels nor span stamps
(PyTorch's, cuBLAS's, cuSOLVER's), by the program's counters: the kernel
nodes the span ``step`` added to each captured graph, averaged over the
schedule's cycle (``ve_steps_per_vm`` VE steps to one VM step)."""

from hetmogp_tpu_torch import profiling


def read(layer):
    report = getattr(profiling, "span_report", None)  # a program without spans
    rep = report() if report is not None else {}
    if layer.get("kind") != "train" or not rep or rep["source"] != "device":
        return None
    if not rep["steps"] or rep["steps"] != sum((layer.get("replayed") or {}).values()):
        return None
    cycle, counters = layer["cycle"], rep["counters"]
    if not all("step" in counters.get(kind, {}) for kind in cycle):
        return None
    return (sum(n * counters[kind]["step"]["library"] for kind, n in cycle.items())
            / sum(cycle.values()))
