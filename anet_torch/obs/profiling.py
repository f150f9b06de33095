"""Profiling hooks: torch.profiler traces + wall-clock stage timing.

The reference's only profiling is a per-frame decode timer whose running
average feeds back into scheduling (playback.cpp:115-130). anet keeps that
idea (PlaybackPipeline's adaptive timeout) and adds the device-side
equivalent (SURVEY.md §5): on-demand profiler traces viewable in
TensorBoard/Perfetto, plus a lightweight stage timer for host code.
``device_trace`` is the port's counterpart of ``anet/obs/profiling.py``'s,
which traces with ``jax.profiler``; this one traces with ``torch.profiler``
(the host's ops, and the card's kernels by their demangled names when CUDA
is there).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace of everything inside the context.

    CPU activity always, CUDA activity when CUDA is available; on exit the
    trace is written by ``torch.profiler.tensorboard_trace_handler`` as
    ``<log_dir>/<worker>.<time>.pt.trace.json`` (``log_dir`` defaults to
    ``anet-torch-trace`` in the temporary directory). View with:
    tensorboard --logdir <log_dir>, or load the .json into Perfetto.
    No-ops gracefully if the profiler is unavailable.
    """
    import torch

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "anet-torch-trace")
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        )
        prof.start()
        started = True
    except Exception:  # noqa: BLE001 — profiling must never break the run
        started = False
    try:
        yield
    finally:
        if started:
            try:
                if cuda:
                    torch.cuda.synchronize()  # kernels still in flight land in the trace
                prof.stop()  # no schedule: stop() hands the trace to the handler
            except Exception:  # noqa: BLE001
                pass


class StageTimer:
    """Accumulating wall-clock timer for named pipeline stages."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 6),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / self.counts[name], 3),
            }
            for name in self.totals
        }
