"""Host-side VAD post-processing: frame posteriors → speech segments.

Port of `toolbox_for_asr_and_tts_tpu/asr/vad.py`: `VadOptions`,
`VadStateMachine` and `segments_from_probs` are copied as they are (pure
Python); `StreamingVadStepper` runs the port's FSMN-VAD.

Equivalent of FunASR's `VadStateMachine` / `WindowDetector` that turns
FSMN-VAD frame probabilities into (start_ms, end_ms) segments with hysteresis,
using the operating constants the FunASR VAD ships with (sil→speech 150 ms,
speech→sil / max end silence 800 ms, speech-noise threshold 0.6, 60 s max
single segment). The reference consumes exactly these segment semantics for
endpointing (voice_interface.py:1580-1602) while its per-chunk gating is
energy-based (ops/vad_energy.py).

Pure Python over numpy — this is control flow, not math; the model math runs
on the card in models/fsmn_vad.py.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import fsmn_vad
from ..models.convert import tree_to
from ..models.paraformer_streaming import StreamingFrontend
from ..runtime.graphs import Program, Programs


@dataclasses.dataclass
class VadOptions:
    frame_ms: int = 10
    speech_noise_thres: float = 0.6
    sil_to_speech_ms: int = 150
    speech_to_sil_ms: int = 150
    max_end_silence_ms: int = 800
    max_single_segment_ms: int = 60000
    speech_pad_ms: int = 0  # lead/tail padding applied to emitted segments
    # FunASR WindowDetector-style majority voting: transitions count voiced
    # frames within a sliding window instead of requiring strict runs
    # (tolerates brief flips). 0 = strict-run hysteresis (default).
    window_ms: int = 0
    vote_ratio: float = 0.8  # fraction of window frames that must agree


class VadStateMachine:
    """Streaming hysteresis detector over per-frame speech probabilities."""

    SIL = 0
    SPEECH = 1

    def __init__(self, opts: VadOptions = VadOptions()):
        self.opts = opts
        self.state = self.SIL
        self.frame_idx = 0
        self.run_len = 0            # consecutive frames contradicting state
        self.seg_start: Optional[int] = None
        self.segments: List[Tuple[int, int]] = []
        from collections import deque
        self._win = deque(maxlen=max(1, opts.window_ms // opts.frame_ms)) \
            if opts.window_ms > 0 else None

    def _emit(self, start_f: int, end_f: int) -> Tuple[int, int]:
        o = self.opts
        seg = (max(0, start_f * o.frame_ms - o.speech_pad_ms),
               end_f * o.frame_ms + o.speech_pad_ms)
        self.segments.append(seg)
        return seg

    def push(self, probs: np.ndarray) -> List[Tuple[int, int]]:
        """Feed frame speech-probabilities; returns segments closed by this
        chunk as (start_ms, end_ms)."""
        o = self.opts
        closed: List[Tuple[int, int]] = []
        up = o.sil_to_speech_ms // o.frame_ms
        end_sil = o.max_end_silence_ms // o.frame_ms
        max_len = o.max_single_segment_ms // o.frame_ms
        for p in np.asarray(probs).reshape(-1):
            is_sp = p > o.speech_noise_thres
            if self._win is not None:
                # windowed voting (WindowDetector style): a frame counts as
                # its window's majority once the window has filled
                self._win.append(is_sp)
                if len(self._win) == self._win.maxlen:
                    votes = sum(self._win)
                    if votes >= o.vote_ratio * len(self._win):
                        is_sp = True
                    elif votes <= (1.0 - o.vote_ratio) * len(self._win):
                        is_sp = False
            if self.state == self.SIL:
                self.run_len = self.run_len + 1 if is_sp else 0
                if self.run_len >= up:
                    self.state = self.SPEECH
                    self.seg_start = self.frame_idx - self.run_len + 1
                    self.run_len = 0
            else:
                self.run_len = 0 if is_sp else self.run_len + 1
                too_long = self.frame_idx - self.seg_start >= max_len
                # FunASR semantics: speech_to_sil_ms flips the FRAME state
                # (surfaced via in_speech); the SEGMENT only closes after
                # max_end_silence_ms — `down` must not gate closing
                # (round-2 review finding: max(down, end_sil) made the
                # speech_to_sil option dead)
                if self.run_len >= end_sil or too_long:
                    end = self.frame_idx - self.run_len + 1
                    closed.append(self._emit(self.seg_start, max(end, self.seg_start + 1)))
                    self.state = self.SIL
                    self.seg_start = None
                    self.run_len = 0
            self.frame_idx += 1
        return closed

    def finalize(self) -> List[Tuple[int, int]]:
        """Close any open segment at end of stream."""
        closed = []
        if self.state == self.SPEECH and self.seg_start is not None:
            closed.append(self._emit(self.seg_start, self.frame_idx))
            self.state = self.SIL
            self.seg_start = None
        return closed

    @property
    def in_speech(self) -> bool:
        """Frame-level state with speech→sil hysteresis: flips false after
        speech_to_sil_ms of silence (FunASR kSpeech→kSil) while the segment
        itself stays open until max_end_silence_ms."""
        down = max(1, self.opts.speech_to_sil_ms // self.opts.frame_ms)
        return self.state == self.SPEECH and self.run_len < down


def segments_from_probs(probs: np.ndarray,
                        opts: VadOptions = VadOptions()) -> List[Tuple[int, int]]:
    """Offline convenience: [T] frame speech probs → [(start_ms, end_ms)]."""
    sm = VadStateMachine(opts)
    out = sm.push(probs)
    out += sm.finalize()
    return out


class StreamingVadStepper:
    """Per-connection FSMN-VAD model stepper: audio chunk → bool speech.

    The reference runs the VAD model on every chunk with a per-session
    cache. Here the cache is the FSMN conv state tensor plus the
    incremental frontend's buffers; the fbank and the model run on `device`
    (the card unless "cpu" is passed). The FSMN step is one program per
    frame count (`runtime/graphs.py`; the reference's "step" fn): the cache
    goes in by copy and comes back out, so sessions may share one
    `Programs` owner (`programs=`)."""

    def __init__(self, params, cfg=None, threshold: float = 0.5, cmvn=None,
                 device: DeviceLike = None,
                 programs: Optional[Programs] = None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg or fsmn_vad.FsmnVadConfig()
        self.threshold = threshold
        self.frontend = StreamingFrontend(self.cfg.frontend, cmvn, self.device)
        self.cache = fsmn_vad.init_cache(1, self.cfg, self.device)
        self.programs = (programs if programs is not None
                         else Programs(self.device, "vad-session"))

    def _step_fn(self, n: int) -> Program:
        """(feats [1, n, D], cache) → (P(speech) [1, n], cache')."""
        def build():
            def run(feats, cache):
                post, new = fsmn_vad.apply_streaming(self.params, feats,
                                                     cache, self.cfg)
                return fsmn_vad.speech_prob(post, self.cfg), new
            return run, [((1, n, self.cfg.input_dim), torch.float32),
                         (tuple(self.cache.shape), self.cache.dtype)]
        return self.programs.get(("step", n), build)

    @torch.inference_mode()
    def __call__(self, chunk: np.ndarray) -> bool:
        feats = self.frontend.push(np.asarray(chunk, np.float32))
        if len(feats) == 0:
            return False
        probs, self.cache = self._step_fn(len(feats))(feats[None], self.cache)
        return bool((probs.cpu().numpy()[0] > self.threshold).any())

    def reset(self) -> None:
        self.frontend.reset()
        self.cache = fsmn_vad.init_cache(1, self.cfg, self.device)
