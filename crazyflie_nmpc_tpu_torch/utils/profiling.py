"""Profiling plane: PyTorch profiler traces + named phase annotation
(counterpart of `utils/profiling.py`).

The reference's only profiling is the per-solve wall time and KKT
residual it reads back from acados (acados_mpc.cpp:614-616) plus
rqt_plot.  Here it is `torch.profiler`: host and device activity with
named ranges for the solver phases, exported as a Chrome trace that
ui.perfetto.dev (or chrome://tracing) opens.

Usage:
    with trace("traces/nmpc"):
        for _ in range(20):
            states, outs = step(states, x0s)
        torch.cuda.synchronize()
    # -> open the file trace_files("traces/nmpc") lists in ui.perfetto.dev

    with phase("rti-prepare"):      # named range inside a trace
        qp = prepare(...)

`phase` is a `torch.profiler.record_function` range (it shows in the
trace and in `key_averages`), and an NVTX range on the card for tools
that read NVTX.
"""

from __future__ import annotations

import contextlib
import glob
import os
import socket
import time

import torch

SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host (+ device, where a GPU is present) profiler trace
    into `log_dir` as `<host>_<pid>.<ms>.pt.trace.json`.

    Synchronize the card on the last output inside the context: kernels
    still queued at its end are not in the trace.
    """
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    name = (f"{socket.gethostname()}_{os.getpid()}."
            f"{int(time.time() * 1e3)}{SUFFIX}")
    prof.export_chrome_trace(os.path.join(log_dir, name))


@contextlib.contextmanager
def phase(name: str):
    """Named range: shows up in the trace timeline (and, on the card, as
    an NVTX range)."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def trace_files(log_dir: str):
    """The Chrome/Perfetto trace artifacts under a trace dir."""
    return sorted(
        glob.glob(os.path.join(log_dir, "**", "*" + SUFFIX), recursive=True)
        + glob.glob(os.path.join(log_dir, "**", "*" + SUFFIX + ".gz"),
                    recursive=True))
