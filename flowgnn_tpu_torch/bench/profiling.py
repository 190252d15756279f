"""Tracing and the XRT profile-summary analog.

The reference turns on XRT's opencl_summary / opencl_trace through xrt.ini
and commits the CSVs (GIN/xrt.ini:1-8, GIN/summary.molhiv.csv). Here:

  * ``trace(logdir, device)`` wraps a region in ``torch.profiler.profile``
    (CPU activity, and CUDA activity on a card) and writes its Chrome-trace
    JSON into ``logdir`` (open it in chrome://tracing or Perfetto): the
    timeline-trace analog;
  * ``KernelStats`` accumulates per-enqueue wall times and emits the same
    "Kernel Execution" CSV the reference publishes, byte for byte the JAX
    package's ``KernelStats.csv``; ``cli run`` writes ``summary.<model>.csv``
    from it.

A departure from ``flowgnn_tpu.bench.profiling.trace``, which catches every
exception around its profiler and then yields a second time: there a
profiler that cannot start lets the region run untraced without a word, and
an exception raised by the traced region itself comes out as contextlib's
"generator didn't stop after throw()". This ``trace`` catches nothing: a
profiler that fails to start raises, and the region's own exception
propagates unchanged (no trace is written then).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str], device="cpu") -> Iterator[None]:
    """``torch.profiler`` over the region, its Chrome trace written to
    ``logdir/trace.<pid>.<ns>.json`` (``logdir`` created if missing); with
    ``logdir`` None it does nothing."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


@dataclasses.dataclass
class KernelStats:
    """Per-enqueue wall times of one named kernel (a whole pass here)."""

    name: str
    times_s: list = dataclasses.field(default_factory=list)

    @contextlib.contextmanager
    def enqueue(self) -> Iterator[None]:
        """Times the region on the host clock and records it."""
        t0 = time.perf_counter()
        yield
        self.times_s.append(time.perf_counter() - t0)

    def csv(self) -> str:
        """XRT summary-style 'Kernel Execution' block
        (cf. GIN/summary.molhiv.csv:39-41)."""
        total = sum(self.times_s) * 1e3
        n = max(len(self.times_s), 1)
        return (
            "Kernel Execution\n"
            "Kernel,Number Of Enqueues,Total Time (ms),Average Time (ms),"
            "Minimum Time (ms),Maximum Time (ms)\n"
            f"{self.name},{len(self.times_s)},{total:.6f},{total / n:.6f},"
            f"{min(self.times_s, default=0) * 1e3:.6f},"
            f"{max(self.times_s, default=0) * 1e3:.6f}\n"
        )
