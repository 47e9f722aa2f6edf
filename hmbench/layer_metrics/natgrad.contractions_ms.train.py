"""Device time a natural-gradient VE step in its contractions, from the
program's spans: ``natgrad.contractions`` (g_m = P^T g_mean and
g_S = P^T diag(c) P), summed over the traced call and divided by the VE
steps it replayed, in ms."""

from hetmogp_tpu_torch import profiling


def read(layer):
    report = getattr(profiling, "span_report", None)  # a program without spans
    rep = report() if report is not None else {}
    if layer.get("kind") != "train" or not rep or rep["source"] != "device":
        return None
    replayed = layer.get("replayed") or {}
    if not rep["steps"] or rep["steps"] != sum(replayed.values()):
        return None
    row = rep["spans"].get("natgrad.contractions")
    if not row or not row["timed"] or row["timed"] != replayed.get("ve"):
        return None
    return row["wall_ms"] / row["timed"]
