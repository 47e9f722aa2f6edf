"""The least time of one average step's products (``roofline/svmogp.py``:
at the published peak of the precision the configuration states for each)
over the window's measured time per step."""


def read(layer):
    if layer.get("kind") != "train":
        return None
    least, cycle = layer["products"], layer["cycle"]
    ms = sum(n * least[k] for k, n in cycle.items()) / sum(cycle.values())
    return 100.0 * ms / (layer["step_s"] * 1e3)
