"""Start-up dispatch profile: the serving knobs that trade host↔device
round trips against padding and compute.

Port of `toolbox_for_asr_and_tts_tpu/runtime/autotune.py`, with the same
names, knob keys and resolution order: an explicit environment variable
beats the profile; TOOLBOX_DISPATCH_PROFILE (`tunnel` | `local`) pins the
profile without a probe; otherwise one probe per process measures the
round trip of a tiny device op plus the fetch of its result and picks
`local` below TUNNEL_RTT_MS, `tunnel` above.

The knobs:
- `tts_mel_group` (TTS_MEL_GROUP): one TTS call per mel bucket;
- `tts_group_by_length` (TTS_GROUP_BY_LENGTH): one TTS call per phone
  bucket;
- `pallas_framing` (USE_PALLAS_FRAMING): the fbank framing kernel K2. On
  the card it is always on: `ops/frontend.py::fbank` raises on a CUDA
  tensor when it is off;
- `batch_capacity` (VOICE_BATCH_CAPACITY): the serving hubs' rows;
- `asr_int16_transfer` (PARAFORMER_TRANSFER_INT16): audio uploaded as
  int16 PCM and rescaled on the device.

Against the reference:
- the platform is the port's device type, `cuda` when the process sees a
  card, else `cpu`; a forced profile is taken at face value as `cuda`, as
  the reference takes it as `tpu`;
- the `cuda` knobs were measured on an H100 by `chip_smoke.py` phase 12
  (PERF.md §6, "dispatch profile"); the `cpu` knobs are the reference's;
- on the card a probe that fails raises, and so does a probe inside a CUDA
  graph capture (a fetch there breaks the capture). Only on the CPU does
  the reference's fallback hold: the tunnel profile, not cached.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict

import torch

from ..device import DeviceLike

logger = logging.getLogger("toolbox.autotune")

# dispatch RTT above this is "remote/tunnel-class"; a directly attached
# card's launch and fetch take well under a millisecond
TUNNEL_RTT_MS = 5.0

_cache: Dict[str, object] = {}


def _platform() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _capturing() -> bool:
    return (torch.backends.cuda.is_built()
            and torch.cuda.is_current_stream_capturing())


def measure_rtt_ms(iters: int = 7, device: DeviceLike = None) -> float:
    """Median wall time of a tiny op on `device` (default: the platform's)
    plus the `.item()` that fetches its result — the unit a dispatch-bound
    path pays per call. The warm-up call is excluded. Raises inside a CUDA
    graph capture."""
    if _capturing():
        raise RuntimeError("the dispatch probe cannot run inside a CUDA "
                           "graph capture: resolve the profile (get_profile) "
                           "before capturing")
    dev = torch.device(device if device is not None else _platform())
    with torch.inference_mode():
        x = torch.zeros((8,), dtype=torch.float32, device=dev)
        (x + 1)[0].item()                 # allocation, first launch
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            (x + 1)[0].item()             # the fetch forces the round trip
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e3


def get_profile(refresh: bool = False) -> Dict[str, object]:
    """{"name": "tunnel"|"local", "rtt_ms": float, "platform": str, knobs…}
    — probed once per process (cached); TOOLBOX_DISPATCH_PROFILE
    overrides."""
    if _cache and not refresh:
        return dict(_cache)
    forced = os.getenv("TOOLBOX_DISPATCH_PROFILE", "").lower()
    probe_failed = False
    if forced in ("tunnel", "local"):
        # explicit override: the named knob set at face value, on the card
        name, rtt, platform = forced, float("nan"), "cuda"
    else:
        platform = _platform()
        try:
            rtt = measure_rtt_ms(device=platform)
        except Exception:
            if platform == "cuda":
                raise             # the card is there: no quiet fallback
            # the CPU's fallback (ref): the safe profile, not cached, so a
            # later call re-probes
            logger.warning("dispatch probe unavailable here — assuming "
                           "tunnel profile (fewest round trips) for now")
            rtt = float("inf")
            probe_failed = True
        name = "local" if rtt < TUNNEL_RTT_MS else "tunnel"
    prof = profile_knobs(name, platform)
    prof["name"] = name
    prof["rtt_ms"] = rtt
    prof["platform"] = platform
    if not probe_failed:
        _cache.clear()
        _cache.update(prof)
        logger.info("dispatch profile: %s (rtt %.3f ms) → %s", name, rtt,
                    {k: v for k, v in prof.items() if k != "rtt_ms"})
    return prof


# The `local` profile on the card, as chip_smoke.py phase 12's rules chose
# it on an NVIDIA H100 80GB HBM3 (700 W); PERF.md §6, "dispatch profile",
# holds the measurements. batch_capacity: the hub rows with the most
# sessions per ms of chunked step + VAD tick among those whose step p95
# stays under 100 ms, the smallest within 10 % of the best (128: the
# rule's pick in 3 of 5 sweeps, 192 in the other 2; the VAD tick's host
# drains decide it, and they vary by machine); each grouping and the int16
# upload: on only where it saved 5 % of the wall or more (per-length
# batching saved 15–19 %; per-mel-bucket calls saved 4.8–6.8 % alone but
# cost 5–13 % on top of it, so off; the int16 upload cost 7–12 %: the
# host rounding outweighs the PCIe bytes saved).
CUDA_LOCAL = {
    "tts_mel_group": False,
    "tts_group_by_length": True,
    "batch_capacity": 128,
    "asr_int16_transfer": False,
}


def profile_knobs(name: str, platform: str = "cuda") -> Dict[str, object]:
    """The knob settings each profile implies (env always wins at the
    consumer). `cpu` keeps the reference's conservative set under either
    name; on `cuda`, `local` takes CUDA_LOCAL and `tunnel` the reference's
    rule for a remote link (16 rows, no groupings, the int16 upload), with
    K2 on either way."""
    if platform == "cuda":
        if name == "local":
            return {**CUDA_LOCAL, "pallas_framing": True}
        return {"tts_mel_group": False, "tts_group_by_length": False,
                "pallas_framing": True, "batch_capacity": 16,
                "asr_int16_transfer": True}
    return {"tts_mel_group": False, "tts_group_by_length": False,
            "pallas_framing": False, "batch_capacity": 16,
            "asr_int16_transfer": False}


def env_or_profile(env_name: str, knob: str) -> bool:
    """Resolve a boolean serving knob: explicit env var beats the probed
    profile."""
    v = os.getenv(env_name)
    if v is not None:
        return v in ("1", "true")
    return bool(get_profile()[knob])


def env_or_profile_int(env_name: str, knob: str) -> int:
    """Integer-valued serving knob: explicit env var beats the probed
    profile."""
    v = os.getenv(env_name)
    if v is not None:
        return int(v)
    return int(get_profile()[knob])
