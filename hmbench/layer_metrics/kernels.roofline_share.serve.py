"""The program's hand kernels in the traced requests: the sum of their
launches' least times (``roofline/launchers.py``, at the shapes recorded
in the traced requests) over the sum of their device times."""

from hmbench.layer_metrics._share import roofline_percent


def read(layer):
    tr = layer.get("trace")
    if layer.get("kind") != "serve" or tr is None or not layer.get("launches"):
        return None
    return roofline_percent(tr, {"requests": (layer["launches"], 1)})
