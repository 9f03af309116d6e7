"""Engine bootstrap: the model bundle the voice service runs on.

Port of `toolbox_for_asr_and_tts_tpu/service/engines.py`. Every engine is
built on `device` (the card unless "cpu" is passed) and served through the
batched hubs (`service/hub.py`) unless VOICE_BATCH_SERVING=0.

- `build_test_engines`: small random-weight engines (the reference's test
  geometry).
- `build_engines`: the full-width engines. The port cannot load a mounted
  checkpoint yet (its `runtime/checkpoints.py` is not ported), so a model
  directory that `runtime/registry.resolve` finds makes it raise instead of
  serving random weights in its place; with no directory it serves random
  weights with the reference's loud warnings.

Hub capacity comes from VOICE_BATCH_CAPACITY, else 64 (the reference's
TPU dispatch profile, `runtime/autotune.py`, is not ported).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

from ..device import DeviceLike, resolve_device
from ..runtime.registry import refuse_checkpoint

logger = logging.getLogger("toolbox.engines")

DEFAULT_CAPACITY = 64


def _batch_serving() -> bool:
    return os.getenv("VOICE_BATCH_SERVING", "1") in ("1", "true")


def _batch_capacity(default: Optional[int] = None) -> int:
    """Serving-hub rows: VOICE_BATCH_CAPACITY, else the caller's default,
    else 64."""
    env = os.getenv("VOICE_BATCH_CAPACITY")
    if env is not None:
        return int(env)
    return default if default is not None else DEFAULT_CAPACITY


def build_test_engines(device: DeviceLike = None):
    """Small random-weight engines for tests and development, on `device`."""
    from ..asr.diarization import Diarizer
    from ..asr.recognizer import Recognizer
    from ..asr.session import VoiceEngines
    from ..asr.speaker import SpeakerVerifier
    from ..models.ct_transformer import Punctuator
    from ..models.kws_ctc import KeywordSpotter
    from ..models.paraformer import ParaformerConfig

    dev = resolve_device(device)
    reco = Recognizer.random(
        ParaformerConfig(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
                         encoder_layers=2, decoder_layers=2, vocab_size=64),
        device=dev)
    sv = SpeakerVerifier.random(device=dev)
    punc = Punctuator.random(device=dev)
    diar = Diarizer(reco, sv, punctuator=punc)
    kws = KeywordSpotter.random(threshold=1e9, device=dev)  # never fires
    if _batch_serving():
        from .hub import FinalizeHub, KwsHub
        diar = FinalizeHub(diar)
        kws = KwsHub(kws)
    # no model VAD: random FSMN-VAD weights fire on silence, which would
    # distort the enrollment FSM's energy-based pacing
    return VoiceEngines(diarizer=diar, kws=kws, verifier=sv,
                        streaming_factory=_streaming_factory(
                            reco, capacity=16, device=dev))


def _vad_factory(model_dir: Optional[str] = None,
                 capacity: Optional[int] = None, device: DeviceLike = None):
    """Per-session FSMN-VAD stepper factory over one weight tree (random:
    the port loads no checkpoint). With batched serving every session's
    chunk joins one VadHub tick; a session past the hub's capacity gets its
    own stepper."""
    from ..asr.vad import StreamingVadStepper
    from ..models import fsmn_vad
    import torch
    dev = resolve_device(device)
    refuse_checkpoint("fsmn_vad", model_dir, "FSMN-VAD")
    cfg = fsmn_vad.FsmnVadConfig()
    params = fsmn_vad.init_params(cfg, torch.Generator().manual_seed(7))
    cmvn = None
    # >1.0 keeps the model's decision False while the device work still runs
    threshold = float(os.getenv("VOICE_VAD_THRESHOLD", "0.5"))

    def per_session():
        return StreamingVadStepper(params, cfg, threshold=threshold,
                                   cmvn=cmvn, device=dev)

    if not _batch_serving():
        return per_session

    from ..parallel.stream_batcher import AtCapacity
    from .hub import HubVadStepper, LanedHub, VadHub, tick_lanes
    cap, lanes = _batch_capacity(capacity), tick_lanes()
    if lanes > 1:
        per = -(-cap // lanes)   # ceil: total capacity never shrinks
        hub = LanedHub(lambda i: VadHub(params, cfg, capacity=per,
                                        threshold=threshold, cmvn=cmvn,
                                        device=dev), lanes)
    else:
        hub = VadHub(params, cfg, capacity=cap, threshold=threshold,
                     cmvn=cmvn, device=dev)

    def factory():
        try:
            return HubVadStepper(hub)
        except AtCapacity:
            logger.warning("VAD hub at capacity — overflow session uses a "
                           "per-session stepper")
            return per_session()

    factory.hub = hub
    return factory


def _streaming_factory(reco, model_dir=None, capacity=None,
                       device: DeviceLike = None):
    """Per-session streaming recognizer factory (2-pass partials, on by
    default; VOICE_ENABLE_PARTIALS=0 turns them off). The chunked online
    Paraformer on the offline weights (the port loads no online
    checkpoint); with batched serving every session's speech chunk joins
    one ChunkedHub tick; VOICE_STREAMING_IMPL=windowed selects the windowed
    re-encode recognizer."""
    if os.getenv("VOICE_ENABLE_PARTIALS", "1") not in ("1", "true"):
        return None
    dev = resolve_device(device if device is not None else reco.device)
    refuse_checkpoint("paraformer_streaming", model_dir,
                      "online ASR (paraformer-zh-streaming)")
    cmvn = None
    if reco.cmvn is not None:
        cmvn = tuple(c.cpu().numpy() for c in reco.cmvn)

    if os.getenv("VOICE_STREAMING_IMPL", "chunked") == "windowed":
        from ..models.paraformer_streaming import (StreamingConfig,
                                                   StreamingRecognizer)

        def factory():
            return StreamingRecognizer(reco.params, reco.cfg, reco.tokenizer,
                                       StreamingConfig(), cmvn=cmvn,
                                       device=dev)
        return factory

    from ..models.paraformer_online import OnlineConfig, OnlineRecognizer

    def per_session():
        return OnlineRecognizer(reco.params, reco.cfg, reco.tokenizer,
                                OnlineConfig(), cmvn=cmvn, device=dev)

    if not _batch_serving():
        return per_session

    from ..parallel.stream_batcher import AtCapacity
    from .hub import ChunkedHub, HubStreamingRecognizer, LanedHub, tick_lanes
    cap, lanes = _batch_capacity(capacity), tick_lanes()
    if lanes > 1:
        per = -(-cap // lanes)
        hub = LanedHub(
            lambda i: ChunkedHub(reco.params, reco.cfg, OnlineConfig(),
                                 reco.tokenizer, cmvn=cmvn, capacity=per,
                                 device=dev), lanes)
    else:
        hub = ChunkedHub(reco.params, reco.cfg, OnlineConfig(),
                         reco.tokenizer, cmvn=cmvn, capacity=cap, device=dev)

    def factory():
        try:
            return HubStreamingRecognizer(hub)
        except AtCapacity:
            logger.warning("chunked hub at capacity — overflow session uses "
                           "a per-session recognizer")
            return per_session()

    factory.hub = hub
    return factory


def build_engines(model_dir: Optional[str] = None,
                  device: DeviceLike = None):
    """Full-width engines on `device`: Paraformer-large, CAM++,
    CT-Transformer (large), KWS and FSMN-VAD, with random weights. A
    checkpoint directory that resolves for any of them raises
    `CheckpointsNotPorted`."""
    from ..asr.diarization import Diarizer
    from ..asr.recognizer import Recognizer
    from ..asr.session import VoiceEngines
    from ..asr.speaker import SpeakerVerifier
    from ..models.ct_transformer import Punctuator
    from ..models.kws_ctc import KeywordSpotter

    dev = resolve_device(device)
    for key, what in (("paraformer_offline", "ASR (Paraformer-large)"),
                      ("sv", "speaker verification (CAM++)"),
                      ("punc", "punctuation (CT-Transformer)"),
                      ("kws", "keyword spotting (charctc)")):
        refuse_checkpoint(key, model_dir, what)
    from ..models.campplus import CampPlusConfig
    from ..models.ct_transformer import CTTransformerConfig
    from ..models.kws_ctc import KwsConfig
    reco = Recognizer.random(device=dev)
    sv = SpeakerVerifier.random(CampPlusConfig(), device=dev)
    punc = Punctuator.random(CTTransformerConfig(), device=dev)
    kws = KeywordSpotter.random(
        KwsConfig(), device=dev,
        threshold=float(os.getenv("VOICE_KWS_THRESHOLD", "1e9")))
    want_kw = os.getenv("VOICE_KWS_KEYWORD", "小护")
    if want_kw != kws.keyword:
        try:
            kws.set_keyword(want_kw)
        except ValueError:
            # an out-of-vocabulary keyword keeps the default keyword
            logger.exception("invalid VOICE_KWS_KEYWORD %r — keeping the "
                             "default keyword %r", want_kw, kws.keyword)
    diar = Diarizer(reco, sv, punctuator=punc)
    if _batch_serving():
        from .hub import FinalizeHub, KwsHub
        diar = FinalizeHub(diar)
        kws = KwsHub(kws)
    return VoiceEngines(diarizer=diar, kws=kws, verifier=sv,
                        vad_factory=_vad_factory(model_dir, device=dev),
                        streaming_factory=_streaming_factory(
                            reco, model_dir, device=dev))
