"""Device time of one call into a layer: the call captured once as a CUDA
graph (after a warm-up on a side stream) and replayed, each replay timed
by CUDA events behind a device sleep, so that the host's launch time lies
outside the events; the median of the replays."""

from __future__ import annotations

import statistics

import torch

SLEEP_CYCLES = 200_000  # ~0.1 ms at the card's clocks: the host's lead


def graph_ms(body, repeats: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    torch.cuda.synchronize()
    graph.replay()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        graph.replay()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in times)
    del graph
    return ms
