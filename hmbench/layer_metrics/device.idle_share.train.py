"""Share of the traced training call in which the device ran nothing: one
minus the union of its activities' intervals over the call's wall time."""

from hmbench.layer_metrics._share import idle_percent


def read(layer):
    return idle_percent(layer, "train")
