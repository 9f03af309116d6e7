"""Profiling: `torch.profiler` traces, the port of
`toolbox_for_asr_and_tts_tpu/runtime/profiling.py`.

    with trace_to("/tmp/tb"):         # host and card trace (Chrome format)
        reco.transcribe(wavs)

    with annotate("finalize"):        # named region inside a trace
        ...

`trace_to` records CPU activity, and the card's kernels and copies when
the device is a card, and writes one Chrome-trace JSON file into the
directory (open it in Perfetto or chrome://tracing).
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

from ..device import DeviceLike, resolve_device

logger = logging.getLogger("toolbox.profiling")

MEMORY_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


@contextlib.contextmanager
def trace_to(logdir: str, device: DeviceLike = None):
    """Profile the block on `device` (the card unless "cpu" is passed) and
    write `<logdir>/trace-<pid>-<ns>.json`; yields that path."""
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)
    logger.info("profile written to %s", path)


def annotate(name: str):
    """A named region inside a trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)


def device_memory_stats(device: DeviceLike = None) -> dict:
    """Per-device memory gauges under the reference's keys: for each card,
    the caching allocator's bytes in use and their peak
    (`torch.cuda.memory_stats`) and the card's total memory
    (`torch.cuda.mem_get_info`). On the CPU (device="cpu") the allocator
    keeps no such gauges: one entry whose values are None, as the
    reference reports for a host device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {str(dev): dict.fromkeys(MEMORY_KEYS)}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        }
    return out
