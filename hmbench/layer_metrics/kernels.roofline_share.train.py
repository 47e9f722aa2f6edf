"""The program's hand kernels in the traced training call: the sum of
their launches' least times (``roofline/launchers.py``, at the shapes the
graphs' capture recorded) over the sum of their device times."""

from hmbench.layer_metrics._share import roofline_percent


def read(layer):
    tr, graphs = layer.get("trace"), layer.get("graphs")
    if layer.get("kind") != "train" or tr is None or not graphs or not layer.get("replayed"):
        return None
    return roofline_percent(tr, {k: (graphs[k], n) for k, n in layer["replayed"].items()})
