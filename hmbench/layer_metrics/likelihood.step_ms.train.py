"""Device time a step in the ELBO's likelihood term, from the program's
spans: ``elbo.likelihood`` (``likelihood_term``'s forward) plus
``backward.likelihood`` (the backward from its start until the moments'
gradients are complete), summed over the traced call and divided by its
steps, in ms."""

from hetmogp_tpu_torch import profiling

NAMES = ("elbo.likelihood", "backward.likelihood")


def read(layer):
    report = getattr(profiling, "span_report", None)  # a program without spans
    rep = report() if report is not None else {}
    if layer.get("kind") != "train" or not rep or rep["source"] != "device":
        return None
    if not rep["steps"] or rep["steps"] != sum((layer.get("replayed") or {}).values()):
        return None
    return sum(rep["spans"][n]["wall_ms"] for n in NAMES if n in rep["spans"]) / rep["steps"]
