"""Device-side tracing on ``torch.profiler`` (port of
``pmfm_tpu/utils/profiling.py``; the reference's profiling hooks were
OpenCL's CL_QUEUE_PROFILING_ENABLE and Vulkan timestamp query pools).

``trace(path)`` records the enclosed region, host and CUDA activity, and
writes a Chrome trace (viewable in Perfetto) into ``path``; the CLI's
``--profile-dir`` turns it on through ``maybe_trace``. ``annotate(name)``
labels a sub-region in the trace; ``device_sync(x)`` waits for the device
work behind the tensors of ``x``.
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


def annotate(name: str):
    """A named sub-region of a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def device_sync(x):
    """Wait until the device has finished the work behind every tensor in
    ``x`` (a tensor, or nested tuples, lists and dicts of them): a
    ``torch.cuda.synchronize`` of each CUDA device among them, nothing for
    CPU tensors. Returns ``x`` unchanged."""
    devices, todo = set(), [x]
    while todo:
        leaf = todo.pop()
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                devices.add(leaf.device)
        elif isinstance(leaf, dict):
            todo.extend(leaf.values())
        elif isinstance(leaf, (tuple, list)):
            todo.extend(leaf)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return x
