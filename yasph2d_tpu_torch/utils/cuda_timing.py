"""Timing of device work with CUDA events (chip_smoke.py, tools/tile_sweep.py).

`graph_ms` takes the host out of a kernel's time: the calls are captured in a
CUDA graph and the graph's replays are timed. The captured function must not
synchronise or copy host data to the device (the port's kernel wrappers and
their glue do neither). Needs a CUDA device; imports nothing at module level
beyond torch.
"""

import statistics

import torch


def event_ms(fn, repeats: int = 7) -> float:
    """Median milliseconds of one eager call, each timed with CUDA events
    after a warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, repeats: int = 7) -> float:
    """Median device milliseconds of one call: `calls` calls captured in a
    CUDA graph after a warm-up call, each replay timed with CUDA events and
    divided by `calls`."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)
