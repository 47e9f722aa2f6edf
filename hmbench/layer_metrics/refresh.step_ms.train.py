"""Device time of the VM step's refresh (the span ``refresh``: Kuu and its
blocked factorization and inverse), the mean over the traced call's VM
steps, in ms."""

from hetmogp_tpu_torch import profiling


def read(layer):
    report = getattr(profiling, "span_report", None)  # a program without spans
    rep = report() if report is not None else {}
    if layer.get("kind") != "train" or not rep or rep["source"] != "device":
        return None
    if not rep["steps"] or rep["steps"] != sum((layer.get("replayed") or {}).values()):
        return None
    return rep["spans"].get("refresh", {}).get("wall_ms_mean")
