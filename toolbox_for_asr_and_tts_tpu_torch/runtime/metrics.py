"""Per-stage timing log lines and real-time-factor accounting.

Own copy of `RTFMeter` and `timing_log` from the reference's
`runtime/metrics.py`. Callers time work that ends in a host fetch (which
waits for the device), so the recorded seconds include the device's time.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger("toolbox.metrics")

TIMING_PREFIX = "耗时统计 -"  # keep the reference's greppable convention


def timing_log(step: str, ms: float) -> None:
    logger.info("%s %s: %.2f ms", TIMING_PREFIX, step, ms)


@dataclass
class RTFMeter:
    """Real-time factor: processing_seconds / audio_seconds (lower is better)."""

    items: List[Dict[str, float]] = field(default_factory=list)

    def record(self, proc_s: float, audio_s: float, label: str = "") -> float:
        rtf = proc_s / max(audio_s, 1e-9)
        self.items.append(
            {"label": label, "proc_s": proc_s, "audio_s": audio_s, "rtf": rtf}
        )
        if rtf > 1.0:
            logger.warning("RTF %.2f > 1.0 for %s — slower than real time", rtf, label)
        return rtf

    @property
    def overall(self) -> Optional[float]:
        if not self.items:
            return None
        proc = sum(i["proc_s"] for i in self.items)
        audio = sum(i["audio_s"] for i in self.items)
        return proc / max(audio, 1e-9)

    def detailed(self) -> Dict[str, Any]:
        return {"overall_rtf": self.overall, "items": list(self.items)}
