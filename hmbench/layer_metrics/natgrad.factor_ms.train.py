"""Device time of one factorization of the natural-gradient step's exact
retraction, from the program's spans and counters: ``natgrad.factor`` (an
attempt's reversed blocked factorization of A and its inverse) summed over
the traced call, over the factorizations the program counted in it
(``natgrad.factorizations``, two a VE step), in ms."""

from hetmogp_tpu_torch import profiling


def read(layer):
    report = getattr(profiling, "span_report", None)  # a program without spans
    rep = report() if report is not None else {}
    if layer.get("kind") != "train" or not rep or rep["source"] != "device":
        return None
    if not rep["steps"] or rep["steps"] != sum((layer.get("replayed") or {}).values()):
        return None
    row = rep["spans"].get("natgrad.factor")
    n = sum(r["counts"].get("natgrad.factorizations", 0) for r in rep["spans"].values())
    if not row or not n or row["timed"] != n:
        return None
    return row["wall_ms"] / n
