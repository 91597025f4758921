"""Timing a kernel on the card with CUDA events.

`time_graph` gives a kernel's own time: many launches captured in a CUDA
graph and replayed, so the Python launch path between calls, tens of
microseconds, stays out of it. `time_calls` gives the time of a call
from Python, that path included, as a caller sees it.
"""

from __future__ import annotations

import torch


def _elapsed_ms(run) -> float:
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def time_calls(fn, inputs, reps: int) -> float:
    """Mean ms of one call of fn, host path included, over `reps` calls
    cycling through `inputs` after three warm-up calls. Inputs whose
    total exceeds the card's 50 MB L2 give each call a cold input."""
    for i in range(3):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()

    def run():
        for i in range(reps):
            fn(inputs[i % len(inputs)])

    return _elapsed_ms(run) / reps


def time_graph(fn, inputs, reps: int) -> float:
    """Mean ms of one launch of fn's kernels: `reps` calls cycling through
    `inputs`, captured in a CUDA graph after three warm-up calls on a side
    stream, replayed once to warm up and once timed. fn must not
    synchronise with the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    return _elapsed_ms(graph.replay) / reps
