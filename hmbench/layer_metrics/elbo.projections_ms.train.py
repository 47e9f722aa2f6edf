"""Device time a step in the ELBO's projections, from the program's spans:
``elbo.projections`` (the forward: the prior factor's wrapper and the
moments) plus ``backward.projections`` (the rest of the backward, the KL's
and the VM step's adjoints in it), summed over the traced call and divided
by its steps, in ms."""

from hetmogp_tpu_torch import profiling

NAMES = ("elbo.projections", "backward.projections")


def read(layer):
    report = getattr(profiling, "span_report", None)  # a program without spans
    rep = report() if report is not None else {}
    if layer.get("kind") != "train" or not rep or rep["source"] != "device":
        return None
    if not rep["steps"] or rep["steps"] != sum((layer.get("replayed") or {}).values()):
        return None
    return sum(rep["spans"][n]["wall_ms"] for n in NAMES if n in rep["spans"]) / rep["steps"]
