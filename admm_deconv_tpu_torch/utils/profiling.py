"""Tracing and timing, counterpart of ``admm_deconv_tpu/utils/profiling.py``.

``torch.profiler`` ranges around solver phases, and a wall-clock iteration
timer that drains the device before the clock starts and after it stops:
CUDA launches return before the card has done the work, so a timer without
the drain measures the launch queue.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named range in a ``torch.profiler`` trace (costs next to nothing
    without one)."""
    with torch.profiler.record_function(name):
        yield


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = tuple(x.values())
    if isinstance(x, (tuple, list)):
        for item in x:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def force_completion(x) -> float:
    """Force completion of the work that produced (the first tensor of)
    ``x`` by fetching its sum to the host; returns that scalar.  The fetch
    waits for everything queued before it on the tensor's stream."""
    leaf = _first_tensor(x)
    if leaf is None:
        raise ValueError("force_completion needs at least one tensor")
    return float(leaf.detach().float().sum())


def _drain() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class IterationTimer:
    """Steady-state wall-clock timer.

    Usage::

        timer = IterationTimer(fn, make_input)   # fresh input per repeat
        stats = timer.measure(repeats=4)
        stats["seconds_per_call"], stats["calls_per_s"]

    Every repeat's input is made, and the device drained, before the clock
    starts; each call's result is fetched before the next one starts.
    """

    def __init__(self, fn: Callable, make_input: Callable[[int], tuple]):
        self.fn = fn
        self.make_input = make_input

    def measure(self, repeats: int = 4, warmup: int = 1) -> dict:
        for i in range(warmup):
            force_completion(self.fn(*self.make_input(-1 - i)))
        inputs = [self.make_input(i) for i in range(repeats)]
        _drain()
        t0 = time.perf_counter()
        for args in inputs:
            force_completion(self.fn(*args))
        _drain()
        elapsed = time.perf_counter() - t0
        per_call = elapsed / repeats
        return {
            "seconds_total": elapsed,
            "seconds_per_call": per_call,
            "calls_per_s": 1.0 / per_call if per_call > 0 else float("inf"),
            "repeats": repeats,
        }


def profile_trace(fn: Callable, *args, log_dir: str = "torch-trace"):
    """Run ``fn(*args)`` under ``torch.profiler`` (CPU activity, and the
    card's when there is one) and write a Chrome trace
    ``log_dir/trace.json`` (open in ``chrome://tracing`` or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        out = fn(*args)
        force_completion(out)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    return out
