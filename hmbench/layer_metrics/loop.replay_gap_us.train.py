"""The device's time between two graphed steps of one call, from the
program's spans: the mean over the traced call's consecutive steps of the
time from one ``step``'s exit stamp to the next one's entry stamp, in us."""

import statistics

from hetmogp_tpu_torch import profiling


def read(layer):
    report = getattr(profiling, "span_report", None)  # a program without spans
    rep = report() if report is not None else {}
    if layer.get("kind") != "train" or not rep or rep["source"] != "device":
        return None
    if not rep["steps"] or rep["steps"] != sum((layer.get("replayed") or {}).values()):
        return None
    groups = rep["groups"]
    gaps = [g["us"] for g in rep["gaps"]
            if groups[g["after"]]["name"] == groups[g["before"]]["name"] == "step"
            and groups[g["after"]]["call"] == groups[g["before"]]["call"]]
    return statistics.mean(gaps) if gaps else None
