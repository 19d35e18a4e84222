"""Device-side tracing on ``torch.profiler`` (port of
``pmfm_tpu/utils/profiling.py``; the reference's profiling hooks were
OpenCL's CL_QUEUE_PROFILING_ENABLE and Vulkan timestamp query pools).

``trace(path)`` records the enclosed region, host and CUDA activity, and
writes a Chrome trace (viewable in Perfetto) into ``path``; the CLI's
``--profile-dir`` turns it on through ``maybe_trace``.
"""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike):
    """Capture a trace of the enclosed region into ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = os.fspath(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def maybe_trace(log_dir: str | os.PathLike | None):
    if log_dir is None:
        yield
    else:
        with trace(log_dir):
            yield
