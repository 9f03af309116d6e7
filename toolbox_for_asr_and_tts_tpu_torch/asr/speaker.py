"""Speaker verification engine: CAM++ embeddings + cosine scoring.

Port of `toolbox_for_asr_and_tts_tpu/asr/speaker.py`. One `embed` call pads
its waveforms to one audio bucket and runs, on the card unless "cpu" is
passed: fbank (kernel K2, one launch) → per-utterance mean subtraction over
the valid frames → CAM++, one program per (batch, audio bucket) (on the
card a captured graph, `runtime/graphs.py`). Enrollment needs ≥ 5 s of speech; verification
compares cosine scores with threshold 0.40.
"""
from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import campplus
from ..models.convert import tree_to
from ..ops import frontend as fe
from ..runtime.bucketing import Bucketer
from ..runtime.graphs import Program, Programs
from ..runtime.metrics import Tally

logger = logging.getLogger("toolbox.speaker")

SV_THRESHOLD = 0.40
MIN_ENROLL_SECONDS = 5.0


class SpeakerVerifier:
    def __init__(self, params, cfg: campplus.CampPlusConfig,
                 threshold: float = SV_THRESHOLD,
                 bucketer: Optional[Bucketer] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.threshold = threshold
        self.fe_cfg = cfg.frontend
        self.bucketer = bucketer or Bucketer.for_audio()
        # one embed program per (batch, samples) bucket; on the card a graph
        self._fns = Programs(self.device, "speaker")
        self.forwards = Tally()   # telemetry: embed programs run (K2 once)

    @classmethod
    def random(cls, cfg: Optional[campplus.CampPlusConfig] = None,
               seed: int = 0, device: DeviceLike = None,
               **kw) -> "SpeakerVerifier":
        """Random weights drawn on the CPU from `seed`, then moved, so the
        card and the CPU hold the same weights for the same seed."""
        dev = resolve_device(device)
        cfg = cfg or campplus.CampPlusConfig(
            block_layers=(2, 2, 2), init_channels=64, embedding_size=64)
        params = campplus.init_params(cfg, torch.Generator().manual_seed(seed))
        return cls(params, cfg, device=dev, **kw)

    @classmethod
    def from_model_dir(cls, model_dir: str,
                       cfg: Optional[campplus.CampPlusConfig] = None,
                       device: DeviceLike = None,
                       **kw) -> "SpeakerVerifier":
        """A `speech_campplus_sv_zh-cn_16k-common` checkpoint dir on `device`
        (the card unless "cpu" is passed); BatchNorm statistics convert as
        leaves of their own (`checkpoints.campplus_rules`)."""
        from ..models.convert import params_from_numpy
        from ..runtime import checkpoints as ckpt
        dev = resolve_device(device)
        cfg = cfg or campplus.CampPlusConfig()
        params = ckpt.convert_or_load_cached(
            model_dir,
            ckpt.shape_template(lambda g: campplus.init_params(cfg, g)),
            ckpt.campplus_rules(cfg.block_layers))
        return cls(params_from_numpy(params, dev), cfg, device=dev, **kw)

    def _fn(self, b: int, n_samples: int) -> Program:
        """The embed program of one (batch, samples) bucket: audio [b,
        n_samples] f32 and lengths [b] int64 → embeddings. Concurrent first
        calls build it once (`Programs.get`)."""
        def build():
            fcfg, cfg = self.fe_cfg, self.cfg
            t_fb = fe.num_fbank_frames(n_samples, fcfg)
            frames = torch.arange(t_fb, device=self.device)

            def run(wavs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
                feats = fe.fbank(wavs, fcfg, t_frames=t_fb)
                # per-utterance cepstral mean subtraction, valid frames
                t_valid = torch.clamp_min(
                    1 + torch.div(lens - fcfg.frame_length,
                                  fcfg.frame_shift, rounding_mode="floor"),
                    1)
                fmask = (frames[None, :] < t_valid[:, None]).float()
                denom = torch.clamp_min(fmask.sum(dim=1, keepdim=True), 1)
                mean = (feats * fmask[..., None]).sum(
                    dim=1, keepdim=True) / denom[..., None]
                feats = (feats - mean) * fmask[..., None]
                return campplus.forward(self.params, feats, t_valid, cfg)
            return run, [((b, n_samples), torch.float32),
                         ((b,), torch.int64)]
        return self._fns.get((b, n_samples), build)

    def embed(self, wavs: List[np.ndarray]) -> np.ndarray:
        """float32 16 kHz waveforms → [N, embed_dim] embeddings."""
        batch, lens = self.bucketer.pad_batch([np.asarray(w) for w in wavs])
        self.forwards.add()
        out = self._fn(batch.shape[0], batch.shape[1])(
            np.asarray(batch, np.float32), lens,
            read=lambda e: e.cpu().numpy())
        return out[: len(wavs)]

    def verify(self, enroll_wav: np.ndarray, test_wav: np.ndarray
               ) -> Tuple[bool, float]:
        """(is_same_speaker, cosine_score)."""
        emb = self.embed([enroll_wav, test_wav])
        score = campplus.cosine_score(emb[0], emb[1])
        return score >= self.threshold, score

    def verify_embedding(self, enroll_emb: np.ndarray, test_wav: np.ndarray
                         ) -> Tuple[bool, float]:
        emb = self.embed([test_wav])[0]
        score = campplus.cosine_score(enroll_emb, emb)
        return score >= self.threshold, score
