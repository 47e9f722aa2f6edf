"""Share of the traced requests' wall time in which the device ran
nothing: one minus the union of its activities' intervals."""

from hmbench.layer_metrics._share import idle_percent


def read(layer):
    return idle_percent(layer, "serve")
