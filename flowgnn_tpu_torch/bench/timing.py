"""Device timings of the port's kernels and paths, shared by ``chip_smoke.py``
and the A/B tools of this package.

``cuda_ms`` times a Python callable with CUDA events: once a launch needs
less device time than its wrapper's host work, a loop of wrapper calls
times the host. ``graph_ms`` captures the callable's launches once in a CUDA
graph and replays it, so only the device time of those launches is left.
Both need a CUDA card; neither is meaningful on the CPU.
"""

from __future__ import annotations


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA
    events around ``reps`` calls after ``warmup`` ones)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: its launches captured
    once in a CUDA graph (after a warm-up call, so plans, weight packs and
    the shared-memory opt-ins are made outside the capture) and the graph
    replayed (``cuda_ms``). The wrappers' host work, which ``cuda_ms`` over
    a Python loop also times once a launch takes less device time than its
    wrapper's host work, drops out. Raises ``RuntimeError`` where the
    launches cannot be captured."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return cuda_ms(graph.replay, reps)
