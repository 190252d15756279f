"""The bench entry's timing protocol on one CUDA card.

The counterpart of ``flowgnn_tpu/bench/protocol.py``, whose measurement
discipline it keeps: the weights and the whole packed stream lie on the
device before timing (``models.base.to_device``), each trial runs ``reps``
passes over every bucket of the stream and ends in one wait, and a trial's
time a pass is reported as the best and the mean over ``trials``. What the
JAX module adds for a TPU behind a relay is not carried over: the passes ran
inside one jitted ``fori_loop`` so that one dispatch covers them, a scalar
carry chained each pass into the embedding table so that XLA could not fold
passes away, buckets were scan-stacked past a threshold to bound compile
time, and ``dispatch_floor`` measured the relay's round trip. Here one CUDA
stream orders the passes by itself, eager PyTorch folds nothing away, and
nothing is compiled, so a trial is a plain loop of ``forward`` calls between
two CUDA events; the host's launch work between the events is part of the
time, as it is of a user's pass. ``dispatch_floor`` is the card's own: one
trivial launch and a wait.

Before the first trial the card runs passes for ``WARMUP_S`` seconds: its
SM clock idles at a few hundred MHz between timings and needs load to reach
its boost clock. On a CPU tensor the timer is the host clock, for the tests.
"""

from __future__ import annotations

import time

import torch

WARMUP_S = 0.5  # seconds of passes before the first trial


def wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm(one_pass, device: torch.device, seconds: float = WARMUP_S) -> None:
    """Run ``one_pass`` until ``seconds`` have passed (at least once),
    waiting for the device after each pass."""
    t0 = time.perf_counter()
    while True:
        one_pass()
        wait(device)
        if time.perf_counter() - t0 >= seconds:
            return


def time_passes(one_pass, reps: int, trials: int, device: torch.device) -> tuple[float, float]:
    """(best, mean) seconds a pass over ``trials`` trials of ``reps`` calls
    of ``one_pass``, after ``warm``: CUDA events around each trial on a
    card, with one wait at its end; the host clock on the CPU."""
    device = torch.device(device)
    warm(one_pass, device)
    times = []
    for _ in range(trials):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                one_pass()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                one_pass()
            t = time.perf_counter() - t0
        times.append(t / reps)
    return min(times), sum(times) / len(times)


def stream_pass(spec, params: dict, batches: list, prec):
    """One pass of ``spec.forward`` over every batch of the stream."""
    def one_pass():
        for batch in batches:
            spec.forward(params, batch, prec)
    return one_pass


def time_stream(spec, params: dict, batches: list, prec, reps: int, trials: int):
    """Time ``reps`` passes of ``spec.forward`` over ``batches`` (already on
    their device) a trial; returns (best, mean) seconds a pass over the whole
    stream (``time_passes``). ``params`` are prepared once, on the same
    device."""
    device = batches[0]["node_feat"].device
    return time_passes(stream_pass(spec, params, batches, prec), reps, trials, device)


def dispatch_floor(prec, trials: int = 3, device="cuda") -> float:
    """The best round trip in seconds of one trivial launch (an in-place add
    to a scalar in the compute dtype) and a wait for it: the card's launch
    floor, which each bucket's launches pay and ``reps`` does not amortise.
    On the CPU, the same operation on the host."""
    device = torch.device(device)
    x = torch.zeros((), dtype=prec.compute_dtype, device=device)
    x.add_(1)
    wait(device)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        x.add_(1)
        wait(device)
        best = min(best, time.perf_counter() - t0)
    return best
