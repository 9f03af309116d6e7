"""Engine bootstrap: the model bundle the voice service runs on.

Port of `toolbox_for_asr_and_tts_tpu/service/engines.py`. Every engine is
built on `device` (the card unless "cpu" is passed) and served through the
batched hubs (`service/hub.py`) unless VOICE_BATCH_SERVING=0.

- `build_test_engines`: small random-weight engines (the reference's test
  geometry).
- `build_engines`: the full-width engines. Each family whose checkpoint
  directory `runtime/registry.resolve` finds is loaded from it
  (`from_model_dir`); a failed load raises, where the reference falls back
  to random weights. A family with no directory gets random weights with
  the reference's loud warning. Every load runs before the first hub
  thread starts.

Hub capacity comes from VOICE_BATCH_CAPACITY, else the caller's, else the
dispatch profile's `batch_capacity` (`runtime/autotune.py`), which
`build_engines` and `build_test_engines` resolve first, before any
program is built. The lanes of
a `LanedHub` share one `exec_cache` per family. Programs built at start-up
(on the card: captured graphs) are built before any session can reach a
hub: each ticker hub's in its constructor, before its tick thread starts,
and the KWS batch programs with VOICE_KWS_AOT=1 before every hub.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

from ..device import DeviceLike, resolve_device
from ..runtime.registry import resolve

logger = logging.getLogger("toolbox.engines")


def _batch_serving() -> bool:
    return os.getenv("VOICE_BATCH_SERVING", "1") in ("1", "true")


def _batch_capacity(default: Optional[int] = None) -> int:
    """Serving-hub rows: VOICE_BATCH_CAPACITY, else the caller's default,
    else the dispatch profile's `batch_capacity`."""
    if default is not None and os.getenv("VOICE_BATCH_CAPACITY") is None:
        return default
    from ..runtime.autotune import env_or_profile_int
    return env_or_profile_int("VOICE_BATCH_CAPACITY", "batch_capacity")


def build_test_engines(device: DeviceLike = None):
    """Small random-weight engines for tests and development, on `device`."""
    from ..runtime.autotune import get_profile
    get_profile()   # host context, before any program is captured
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
        device=dev, use_mesh=False)
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


def _load(key: str, model_dir: Optional[str], what: str, loader, fallback):
    """The family `key` loaded from its resolved checkpoint directory
    (`loader(dir)`; a failure raises), else `fallback()` with a loud
    warning: random weights only where no directory resolves."""
    d = resolve(key, model_dir)
    if d is None:
        logger.warning(
            "NO %s checkpoint dir (registry key %r) — serving RANDOMLY "
            "INITIALIZED weights: outputs are arbitrary until a real model "
            "is mounted", what, key)
        return fallback()
    eng = loader(d)
    logger.info("%s loaded from %s", what, d)
    return eng


def _vad_factory(model_dir: Optional[str] = None,
                 capacity: Optional[int] = None, device: DeviceLike = None):
    """Per-session FSMN-VAD stepper factory over one weight tree: the
    resolved `fsmn_vad` checkpoint (geometry and am.mvn CMVN from the dir
    itself), else random weights. With batched serving every session's
    chunk joins one VadHub tick; a session past the hub's capacity gets its
    own stepper."""
    from ..asr.vad import StreamingVadStepper
    from ..models import fsmn_vad
    from ..runtime.graphs import Programs
    import torch
    dev = resolve_device(device)

    def random_vad():
        cfg = fsmn_vad.FsmnVadConfig()
        return (fsmn_vad.init_params(cfg, torch.Generator().manual_seed(7)),
                cfg, None)
    params, cfg, cmvn = _load(
        "fsmn_vad", model_dir, "FSMN-VAD",
        lambda d: fsmn_vad.from_model_dir(d, device=dev), random_vad)
    # >1.0 keeps the model's decision False while the device work still runs
    threshold = float(os.getenv("VOICE_VAD_THRESHOLD", "0.5"))

    overflow = Programs(dev, "vad-sessions")   # the sessions' programs

    def per_session():
        return StreamingVadStepper(params, cfg, threshold=threshold,
                                   cmvn=cmvn, device=dev, programs=overflow)

    if not _batch_serving():
        return per_session

    from ..parallel.stream_batcher import AtCapacity
    from .hub import HubVadStepper, LanedHub, VadHub, tick_lanes
    cap, lanes = _batch_capacity(capacity), tick_lanes()
    if lanes > 1:
        per = -(-cap // lanes)   # ceil: total capacity never shrinks
        shared: dict = {}        # the lanes' shared programs
        hub = LanedHub(lambda i: VadHub(params, cfg, capacity=per,
                                        threshold=threshold, cmvn=cmvn,
                                        exec_cache=shared, device=dev),
                       lanes)
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


def _partials_enabled() -> bool:
    return os.getenv("VOICE_ENABLE_PARTIALS", "1") in ("1", "true")


def _online_recognizer(reco, model_dir: Optional[str] = None,
                       device: DeviceLike = None):
    """The recognizer whose weights the streaming partials use: the
    separately trained online checkpoint (`paraformer_streaming`) where its
    directory resolves, else the offline recognizer `reco`."""
    from ..asr.recognizer import Recognizer
    dev = resolve_device(device if device is not None else reco.device)
    d = resolve("paraformer_streaming", model_dir)
    if d is None:
        logger.warning("no online (paraformer-zh-streaming) checkpoint dir —"
                       " streaming partials reuse the offline ASR weights")
        return reco
    online = Recognizer.from_model_dir(d, device=dev, use_mesh=False)
    logger.info("streaming partials use the online checkpoint %s", d)
    return online


def _streaming_factory(reco, capacity=None, device: DeviceLike = None):
    """Per-session streaming recognizer factory over `reco`'s weights
    (2-pass partials, on by default; VOICE_ENABLE_PARTIALS=0 turns them
    off): the chunked online Paraformer; with batched serving every
    session's speech chunk joins one ChunkedHub tick;
    VOICE_STREAMING_IMPL=windowed selects the windowed re-encode
    recognizer."""
    if not _partials_enabled():
        return None
    dev = resolve_device(device if device is not None else reco.device)
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
    from ..runtime.graphs import Programs

    overflow = Programs(dev, "online-sessions")   # the sessions' programs

    def per_session():
        return OnlineRecognizer(reco.params, reco.cfg, reco.tokenizer,
                                OnlineConfig(), cmvn=cmvn, device=dev,
                                programs=overflow)

    if not _batch_serving():
        return per_session

    from ..parallel.stream_batcher import AtCapacity
    from .hub import ChunkedHub, HubStreamingRecognizer, LanedHub, tick_lanes
    cap, lanes = _batch_capacity(capacity), tick_lanes()
    if lanes > 1:
        per = -(-cap // lanes)
        shared: dict = {}        # the lanes' shared programs
        hub = LanedHub(
            lambda i: ChunkedHub(reco.params, reco.cfg, OnlineConfig(),
                                 reco.tokenizer, cmvn=cmvn, capacity=per,
                                 exec_cache=shared, device=dev), lanes)
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
                  device: DeviceLike = None, use_mesh: bool = True):
    """Full-width engines on `device`: Paraformer-large (offline, and the
    online checkpoint for the partials), CAM++, CT-Transformer (large),
    KWS and FSMN-VAD, each loaded from its checkpoint directory where one
    resolves under `model_dir` (or the registry's default roots), else with
    random weights. A failed load raises before any hub thread starts.
    use_mesh: the offline recognizer serves over every local device of
    `device`'s platform (`Recognizer(use_mesh=True)`); the online
    checkpoint's recognizer, which feeds the streaming partials, does not,
    as in the reference."""
    from ..runtime.autotune import get_profile
    get_profile()   # host context, before any program is captured
    from ..asr.diarization import Diarizer
    from ..asr.recognizer import Recognizer
    from ..asr.session import VoiceEngines
    from ..asr.speaker import SpeakerVerifier
    from ..models.campplus import CampPlusConfig
    from ..models.ct_transformer import CTTransformerConfig, Punctuator
    from ..models.kws_ctc import KeywordSpotter, KwsConfig

    dev = resolve_device(device)
    reco = _load("paraformer_offline", model_dir, "ASR (Paraformer-large)",
                 lambda d: Recognizer.from_model_dir(d, device=dev,
                                                     use_mesh=use_mesh),
                 lambda: Recognizer.random(device=dev, use_mesh=use_mesh))
    sv = _load("sv", model_dir, "speaker verification (CAM++)",
               lambda d: SpeakerVerifier.from_model_dir(d, device=dev),
               lambda: SpeakerVerifier.random(CampPlusConfig(), device=dev))
    punc = _load("punc", model_dir, "punctuation (CT-Transformer)",
                 lambda d: Punctuator.from_model_dir(d, device=dev),
                 lambda: Punctuator.random(CTTransformerConfig(), device=dev))
    # loaded with the default keyword; VOICE_KWS_KEYWORD applies after, so
    # an out-of-vocabulary keyword keeps the loaded weights
    kws_thr = dict(threshold=float(os.getenv("VOICE_KWS_THRESHOLD", "1e9")))
    kws = _load("kws", model_dir, "keyword spotting (charctc)",
                lambda d: KeywordSpotter.from_model_dir(d, device=dev,
                                                        **kws_thr),
                lambda: KeywordSpotter.random(KwsConfig(), device=dev,
                                              **kws_thr))
    online = (_online_recognizer(reco, model_dir, dev)
              if _partials_enabled() else reco)
    want_kw = os.getenv("VOICE_KWS_KEYWORD", "小护")
    if want_kw != kws.keyword:
        try:
            kws.set_keyword(want_kw)
        except ValueError:
            # an out-of-vocabulary keyword keeps the default keyword
            logger.exception("invalid VOICE_KWS_KEYWORD %r — keeping the "
                             "default keyword %r", want_kw, kws.keyword)
    diar = Diarizer(reco, sv, punctuator=punc)
    if _batch_serving() and os.getenv("VOICE_KWS_AOT", "0") in ("1", "true"):
        # wake-enabled deployments build the pow-2 batch programs at boot;
        # off by default, as most keep wake gating off until a real KWS
        # checkpoint is mounted
        kws.warm(max_batch=int(os.getenv("VOICE_KWS_MAX_BATCH", "64")))
    # the VAD loads last; each ticker hub builds its programs before its own
    # tick thread starts, and the gather hubs start after both
    vad_factory = _vad_factory(model_dir, device=dev)
    streaming_factory = _streaming_factory(online, device=dev)
    if _batch_serving():
        from .hub import FinalizeHub, KwsHub
        diar = FinalizeHub(diar)
        kws = KwsHub(kws)
    return VoiceEngines(diarizer=diar, kws=kws, verifier=sv,
                        vad_factory=vad_factory,
                        streaming_factory=streaming_factory)
