"""The program's hand-kernel launches over the window's requests, by its
launch counters, per request."""


def read(layer):
    if layer.get("kind") != "serve":
        return None
    return layer.get("launches_per_request")
