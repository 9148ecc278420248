"""Profiling hooks (port of ``otamg/diag/profiling.py``): a
``torch.profiler`` trace of a block and a per-call timer that waits for
the device."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CUDA activity too when
    a card is present) and write a Chrome trace, viewable in Perfetto,
    into ``logdir`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _synchronize(out) -> None:
    """Wait for every CUDA device holding a tensor of ``out`` (a tensor
    or a tuple, list or dict of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _synchronize(v)


class Timer:
    """Wall-clock timer that waits for the device of ``box["out"]``
    before reading the clock, so device work is measured."""

    def __init__(self):
        self.records: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        box = {}
        yield box
        if "out" in box:
            _synchronize(box["out"])
        self.records.setdefault(name, []).append(
            time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for k, v in self.records.items():
            out[k] = {"n": len(v), "total_s": sum(v),
                      "mean_ms": 1e3 * sum(v) / len(v),
                      "min_ms": 1e3 * min(v)}
        return out
