"""The median over the window's calls of the share of a call's wall time
until the host has enqueued its last graph replay: near 100%, the host's
replay loop sets the pace."""

import statistics


def read(layer):
    if layer.get("kind") != "train" or not layer.get("host_shares"):
        return None
    return 100.0 * statistics.median(layer["host_shares"])
