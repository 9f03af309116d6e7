"""Fixed-shape bucketing of utterance lengths.

Own copy of the reference's `runtime/bucketing.py` (`Bucketer`,
`CompileCacheStats`). Every length
rounds up to one of a small set of buckets with an explicit valid-length
mask, so a batch of mixed lengths runs as one padded batch and the port's
results match the reference's bucket for bucket.
"""
from __future__ import annotations

import bisect
import logging
from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np

# Seconds buckets for utterance-level (offline) ASR windows: utterances are
# finalized after 2 s of silence and segments cap at 60 s, so this covers
# the operating envelope with ~25% worst-case padding waste.
DEFAULT_AUDIO_BUCKETS_S: Tuple[float, ...] = (1, 2, 4, 6, 8, 10, 15, 20, 30, 45, 60, 90, 120)


@dataclass(frozen=True)
class Bucketer:
    """Rounds lengths up into a fixed set of buckets.

    `sizes` are in element units (e.g. samples or frames or chars).
    """

    sizes: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(sorted(int(s) for s in self.sizes)))
        if not self.sizes:
            raise ValueError("Bucketer needs at least one size")

    @classmethod
    def for_audio(cls, sample_rate: int = 16000,
                  seconds: Sequence[float] = DEFAULT_AUDIO_BUCKETS_S) -> "Bucketer":
        return cls(tuple(int(round(s * sample_rate)) for s in seconds))

    def bucket(self, n: int) -> int:
        """Smallest bucket >= n (clamps to the largest bucket)."""
        i = bisect.bisect_left(self.sizes, n)
        if i == len(self.sizes):
            return self.sizes[-1]
        return self.sizes[i]

    def _warn_truncate(self, n: int, b: int) -> None:
        logging.getLogger("toolbox.bucketing").warning(
            "input length %d exceeds the largest bucket %d — TRUNCATING "
            "%d elements; long audio should go through "
            "Recognizer.transcribe_long's silence-aware splitter instead",
            n, b, n - b)

    def pad_1d(self, x: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pad a 1-D array up to its bucket. Returns (padded, valid_len).
        Inputs beyond the LARGEST bucket are truncated with a warning."""
        n = x.shape[0]
        b = self.bucket(n)
        if n >= b:
            if n > b:
                self._warn_truncate(n, b)
            return np.asarray(x[:b]), min(n, b)
        out = np.zeros((b,) + x.shape[1:], dtype=x.dtype)
        out[:n] = x
        return out, n

    def pad_batch(self, xs: Sequence[np.ndarray], batch_multiple: int = 1
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad a list of 1-D arrays to (B, T) with one shared bucket.

        B is rounded up to `batch_multiple` with zero rows. Returns
        (batch, valid_lens).
        """
        if not xs:
            raise ValueError("empty batch")
        t = self.bucket(max(x.shape[0] for x in xs))
        b = ((len(xs) + batch_multiple - 1) // batch_multiple) * batch_multiple
        out = np.zeros((b, t) + xs[0].shape[1:], dtype=xs[0].dtype)
        lens = np.zeros((b,), dtype=np.int32)
        for i, x in enumerate(xs):
            n = min(x.shape[0], t)
            if x.shape[0] > t:
                self._warn_truncate(x.shape[0], t)
            out[i, :n] = x[:n]
            lens[i] = n
        return out, lens


@dataclass
class CompileCacheStats:
    """Book-keeping for how many distinct shapes a serving path has seen."""

    shapes: set = field(default_factory=set)

    def record(self, *shape) -> bool:
        """Returns True if this shape is new (on the card: a new program to
        capture)."""
        key = tuple(shape)
        new = key not in self.shapes
        self.shapes.add(key)
        return new
