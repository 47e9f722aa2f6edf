"""The device's time between two served requests, from the program's
spans: the median over the traced requests of the time from one
``serve.request``'s exit stamp to the next one's entry stamp, in us."""

import statistics

from hetmogp_tpu_torch import profiling


def read(layer):
    report = getattr(profiling, "span_report", None)  # a program without spans
    rep = report() if report is not None else {}
    if layer.get("kind") != "serve" or not rep or rep["source"] != "device":
        return None
    groups = rep["groups"]
    gaps = [g["us"] for g in rep["gaps"]
            if groups[g["after"]]["name"] == groups[g["before"]]["name"] == "serve.request"]
    return statistics.median(gaps) if gaps else None
