"""Offline ASR engine: wav → text on the card, one program per bucket.

Port of `toolbox_for_asr_and_tts_tpu/asr/recognizer.py`. The chain

    fbank (kernel K2) → LFR → CMVN → SAN-M encoder (kernel K1 in every
    layer) → CIF → NAR decoder (K1) → greedy argmax

runs on one padded batch per call: utterances pad up to a shared audio
bucket (`runtime/bucketing.py`), and each row is held to its valid length
by masks, so results match the reference row for row. Optional phase-2
rescoring (hotwords, n-gram LM) re-decodes at a tight token bucket and
takes a float64 log-softmax of the bf16-cast logits on the host.

Each (batch, audio bucket) forward and each rescoring bucket is one program
(`runtime/graphs.py`; the reference's `_fn_for` / `_logits_fn`): on the
card a captured CUDA graph, replayed with the audio copied in from pinned
memory and the packed per-token outputs fetched in one copy. Bucketing,
that fetch, rescoring's log-softmax and the text stay on the host.

`use_mesh=True` (the default, as the reference's) serves over
`runtime/mesh.py::serving_mesh()`: the batch pads to a multiple of the
mesh's positions and splits into one contiguous block of rows per
position; each position replays its own programs (its own K2 and K1
launches) on its device's replica of the parameters (one replica per
distinct device), and each position's outputs come back in one fetch. The
fetches are queued before any is waited on, so distinct cards overlap. On
a one-card host the mesh has one position: the programs and launches are
those of `use_mesh=False`.

PARAFORMER_TRANSFER_INT16 (else the dispatch profile's
`asr_int16_transfer`, `runtime/autotune.py`), read at construction: the
host rounds the padded batch to int16 PCM (`to_int16_pcm`), the staging
buffer is int16, and the program turns it back into f32 · 2^-15 before the
fbank, so kernel K2 gets the same f32 input as on the f32 path; on
PCM-sourced audio the two paths are bit-equal. The mode is part of the
program key.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import paraformer
from ..models.convert import tree_to
from ..ops import frontend as fe
from ..ops import nn
from ..runtime.bucketing import Bucketer
from ..runtime.graphs import Program, Programs, to_host
from ..runtime.mesh import per_position, serving_mesh
from ..runtime import profiling
from ..runtime.metrics import Tally, real_time_factor, timing_log
from .tokenizer import CharTokenizer


def to_int16_pcm(x: np.ndarray) -> np.ndarray:
    """f32 audio → int16 PCM for the upload, in the reference's order:
    clip(round(x·32768), −32768, 32767); exact for PCM-sourced audio."""
    return np.clip(np.round(x * 32768.0), -32768.0, 32767.0).astype(np.int16)


def from_int16_pcm(x: torch.Tensor) -> torch.Tensor:
    """The device side of the int16 upload: int16 → f32 · 2^-15."""
    return x.float() * (1.0 / 32768.0)


@dataclasses.dataclass
class TranscribeResult:
    text: str
    tokens: List[str]
    token_ids: List[int]
    timestamps_ms: List[int]          # per-token refined instant (CIF center)
    timestamp: Optional[List[Tuple[int, int]]] = None  # FunASR-style
                                      # [start_ms, end_ms] spans per token
    audio_s: float = 0.0
    rtf: Optional[float] = None


class Recognizer:
    """Batched offline Paraformer recognizer over padded audio buckets."""

    K_BUCKET = 16  # token-count granularity of the rescoring pass

    def __init__(self, params, cfg: paraformer.ParaformerConfig,
                 tokenizer: CharTokenizer,
                 cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 bucketer: Optional[Bucketer] = None,
                 device: DeviceLike = None,
                 param_dtype: Optional[torch.dtype] = None,
                 lm=None, lm_weight: float = 0.3, use_mesh: bool = True):
        """params: a Paraformer tensor tree (moved to `device`); device:
        the card unless "cpu" is passed; use_mesh: serve over
        `serving_mesh(device=device)`, every local device of the platform
        (`self.device` is then the mesh's first), else on `device` alone;
        param_dtype: the floating leaves'
        dtype (torch.bfloat16 halves the weights; the products still run
        in f32, `nn.dot`); lm: optional asr.ngram_lm.ArpaLM fused into
        decoding, loaded from $NGRAM_LM_FILE when none is passed unless
        FUNASR_DISABLE_LM is set (a file that fails to load raises).
        PARAFORMER_QUANT=int8 quantizes the encoder's linears (W8A8,
        `paraformer.quantize_encoder_int8`) after the cast, as the
        reference does; any other value leaves the tree as it is."""
        self.device = resolve_device(device)
        self.mesh = serving_mesh(device=self.device) if use_mesh else None
        positions = (self.mesh.positions() if self.mesh is not None
                     else [self.device])
        self.device = positions[0]
        self.cfg = cfg
        self.tokenizer = tokenizer
        if lm is None and os.getenv("NGRAM_LM_FILE") \
                and not os.getenv("FUNASR_DISABLE_LM"):
            from .ngram_lm import ArpaLM
            lm = ArpaLM.load(os.environ["NGRAM_LM_FILE"])
        self.lm = lm
        self.lm_weight = lm_weight
        self.fe_cfg = cfg.frontend
        self.bucketer = bucketer or Bucketer.for_audio(self.fe_cfg.sample_rate)
        params = tree_to(params, self.device, param_dtype)
        if os.getenv("PARAFORMER_QUANT", "") == "int8":
            params = paraformer.quantize_encoder_int8(params)
        self.params = params          # position 0's tree
        self.cmvn = None
        if cmvn is not None:
            self.cmvn = tuple(torch.as_tensor(np.asarray(c, np.float32),
                                              device=self.device)
                              for c in cmvn)
        # (params, cmvn) per mesh position, one copy per distinct device
        self._replicas = list(zip(per_position(self.params, positions),
                                  per_position(self.cmvn, positions)))
        # int16 audio upload: an explicit env var wins, else the profile
        from ..runtime.autotune import env_or_profile
        self._int16_transfer = env_or_profile("PARAFORMER_TRANSFER_INT16",
                                              "asr_int16_transfer")
        # one program per (batch, audio bucket) forward and per rescoring
        # bucket; on the card each is a captured graph
        self._positions = [Programs(dev, "recognizer" if i == 0
                                    else f"recognizer@{i}")
                           for i, dev in enumerate(positions)]
        self._programs = self._positions[0]
        # device programs run (telemetry): forwards (K2 once, K1 in
        # every encoder and decoder layer) and the rescoring re-decode
        self.forwards = Tally()
        self.rescorings = Tally()
        # ms per LFR frame (frame_shift 10 ms × lfr_n)
        self.frame_ms = self.fe_cfg.frame_shift_ms * self.fe_cfg.lfr_n
        # BiCIF timestamp branch: upsampled fire frames refine spans to
        # frame_ms / upsample_times
        self.has_bicif = isinstance(params.get("predictor"), dict) \
            and "upsample" in params["predictor"]
        self.us_ms = self.frame_ms / cfg.upsample_times

    # ------------------------------------------------------------ factory
    @classmethod
    def random(cls, cfg: Optional[paraformer.ParaformerConfig] = None,
               seed: int = 0, device: DeviceLike = None,
               **kw) -> "Recognizer":
        """Random weights drawn on the CPU from `seed`, then moved, so the
        card and the CPU hold the same weights for the same seed."""
        device = resolve_device(device)
        cfg = cfg or paraformer.ParaformerConfig()
        params = paraformer.init_params(
            cfg, torch.Generator().manual_seed(seed))
        return cls(params, cfg, CharTokenizer.dummy(cfg.vocab_size),
                   device=device, **kw)

    @classmethod
    def from_model_dir(cls, model_dir: str,
                       cfg: Optional[paraformer.ParaformerConfig] = None,
                       device: DeviceLike = None, **kw) -> "Recognizer":
        """Load a ModelScope Paraformer checkpoint directory (tokens, am.mvn,
        model weights; see runtime/checkpoints.py) onto `device` (the card
        unless "cpu" is passed). Geometry comes from the directory's config
        and the vocab size from its own token list.

        BiCIF auto-detect: the spk model (BiCifParaformer) carries the
        upsampled timestamp predictor; plain vocab8404 checkpoints do not.
        The bicif template is tried first, and the plain one when its
        tensors are absent (KeyError) or shaped otherwise (ValueError)."""
        from ..models.convert import params_from_numpy
        from ..runtime import checkpoints as ckpt
        device = resolve_device(device)
        tok_path = next((p for p in (os.path.join(model_dir, c) for c in
                                     ("tokens.json", "tokens.txt"))
                         if os.path.exists(p)), None)
        tokenizer = CharTokenizer.load(tok_path) if tok_path else None
        if cfg is None:
            cfg = paraformer.ParaformerConfig.from_funasr(
                ckpt.load_model_config(model_dir))
            n_vocab = len(tokenizer.tokens) if tokenizer else 0
            if n_vocab and n_vocab != cfg.vocab_size:
                cfg = dataclasses.replace(cfg, vocab_size=n_vocab)

        def convert(c: paraformer.ParaformerConfig):
            return ckpt.convert_or_load_cached(
                model_dir,
                ckpt.shape_template(lambda g: paraformer.init_params(c, g)),
                ckpt.paraformer_rules(c.encoder_layers, c.decoder_layers,
                                      bicif=c.bicif))
        try:
            bcfg = dataclasses.replace(cfg, bicif=True)
            params = convert(bcfg)
            cfg = bcfg
        except (KeyError, ValueError):
            params = convert(cfg)
        cmvn = None
        mvn_path = os.path.join(model_dir, "am.mvn")
        if os.path.exists(mvn_path):
            cmvn = ckpt.parse_kaldi_cmvn(mvn_path)
        return cls(params_from_numpy(params, device), cfg,
                   tokenizer or CharTokenizer.dummy(cfg.vocab_size),
                   cmvn=cmvn, device=device, **kw)

    # ----------------------------------------------------------- forward
    def _forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor,
                 pos: int = 0) -> Dict[str, torch.Tensor]:
        """The eager forward of one bucket on mesh position `pos`'s
        replica: padded audio [B, n_samples] f32 and valid lengths [B]
        int64 on its device → `paraformer.forward`'s outputs plus
        `feat_lens`."""
        params, cmvn = self._replicas[pos]
        n_samples = wavs.shape[1]
        fcfg = self.fe_cfg
        t_fb = fe.num_fbank_frames(n_samples, fcfg)
        t_lfr = fe.num_lfr_frames(t_fb, fcfg.lfr_n)
        k_max = paraformer.max_tokens_for(t_lfr)
        feats = fe.fbank(wavs, fcfg, t_frames=t_fb)
        # replicate-last LFR repeats the last VALID fbank frame, not frames
        # framed over the bucket's zero padding
        vfb = fe.num_valid_fbank_frames(wav_lens, fcfg)
        feats = fe.apply_lfr(feats, fcfg.lfr_m, fcfg.lfr_n, t_out=t_lfr,
                             valid_frames=vfb)
        if cmvn is not None:
            feats = fe.apply_cmvn(feats, cmvn[0], cmvn[1])
        feat_lens = fe.frontend_valid_frames(wav_lens, fcfg)
        out = paraformer.forward(params, feats, feat_lens, k_max, self.cfg)
        out["feat_lens"] = feat_lens
        return out

    @torch.inference_mode()
    def forward_padded(self, batch: np.ndarray, lens: np.ndarray
                       ) -> Dict[str, torch.Tensor]:
        """Padded audio [B, n_samples] (one bucket) and valid lengths [B] →
        `paraformer.forward`'s outputs on the device, plus `feat_lens`: the
        eager call, run directly on mesh position 0 (`transcribe` replays
        its programs)."""
        self.forwards.add()
        return self._forward(
            torch.from_numpy(np.asarray(batch, np.float32)).to(self.device),
            torch.from_numpy(np.asarray(lens, np.int64)).to(self.device))

    def _fn_for(self, batch: int, n_samples: int, pos: int = 0) -> Program:
        """The forward program of one (batch, samples, int16 upload) bucket
        on mesh position `pos` (ref `_fn_for`): audio and lengths → every
        per-token output packed into one f32 array [B, 1 + n·k_max] (one
        fetch), and the tensors
        the rescoring pass re-decodes from (`enc`, `embeds`, `feat_lens`,
        `token_count`), kept on the device."""
        int16_in = self._int16_transfer

        def build():
            def run(wavs, wav_lens):
                if int16_in:
                    wavs = from_int16_pcm(wavs)
                out = self._forward(wavs, wav_lens, pos)
                cols = [out["token_count"][:, None], out["tokens"],
                        out["token_center"], out["token_start"],
                        out["fire_frame"]]
                if self.has_bicif:   # BiCIF 20 ms timestamp boundaries
                    cols += [out["us_start"], out["us_end"]]
                packed = torch.cat([c.float() for c in cols], dim=1)
                return {"packed": packed,
                        **{k: out[k] for k in self._RESCORING_INPUTS}}
            return run, [((batch, n_samples),
                          torch.int16 if int16_in else torch.float32),
                         ((batch,), torch.int64)]
        return self._positions[pos].get(
            ("forward", batch, n_samples, int16_in), build)

    _RESCORING_INPUTS = ("embeds", "token_count", "enc", "feat_lens")

    def _rescore(self, embeds: torch.Tensor, token_count: torch.Tensor,
                 enc: torch.Tensor, feat_lens: torch.Tensor,
                 k_b: int, pos: int = 0) -> torch.Tensor:
        token_mask = nn.length_mask(torch.clamp_max(token_count, k_b), k_b)
        mem_mask = nn.length_mask(feat_lens, enc.shape[1])
        logits = paraformer.decode(self._replicas[pos][0], embeds[:, :k_b],
                                   token_mask,
                                   enc, mem_mask, self.cfg)
        return logits.to(torch.bfloat16)

    @torch.inference_mode()
    def rescoring_logits(self, embeds: torch.Tensor, token_count: torch.Tensor,
                         enc: torch.Tensor, feat_lens: torch.Tensor,
                         k_b: int) -> torch.Tensor:
        """Phase 2: re-decode the first `k_b` CIF embeds → bf16 logits
        [B, k_b, V] (the cast the reference makes before its fetch): the
        eager call, run directly (`transcribe` replays its program)."""
        self.rescorings.add()
        return self._rescore(embeds, token_count, enc, feat_lens, k_b)

    def _logits_fn(self, batch: int, t_lfr: int, k_b: int,
                   pos: int = 0) -> Program:
        """The rescoring program of one (batch, t_lfr, k_b) bucket on mesh
        position `pos` (ref `_logits_fn`)."""
        def build():
            k_max = paraformer.max_tokens_for(t_lfr)
            d = self.cfg.d_model
            return (lambda e, n, m, f: self._rescore(e, n, m, f, k_b, pos),
                    [((batch, k_max, d), torch.float32),
                     ((batch,), torch.int32),
                     ((batch, t_lfr, d), torch.float32),
                     ((batch,), torch.int64)])
        return self._positions[pos].get(("logits", batch, t_lfr, k_b),
                                        build)

    def _bucket_shapes(self, n_samples: int) -> Tuple[int, int]:
        """(t_lfr, k_max) of an audio bucket."""
        t_fb = fe.num_fbank_frames(n_samples, self.fe_cfg)
        t_lfr = fe.num_lfr_frames(t_fb, self.fe_cfg.lfr_n)
        return t_lfr, paraformer.max_tokens_for(t_lfr)

    # ----------------------------------------------------------- public
    def transcribe(self, wavs: Sequence[np.ndarray],
                   hotwords: Optional[dict] = None) -> List[TranscribeResult]:
        """Batch of float32 mono 16 kHz waveforms → results.

        `hotwords` ({word: weight}) applies constrained rescoring of the
        greedy output (asr/hotword_bias.py).

        Spans (`runtime/profiling.py`): `recognizer.transcribe`, the
        request, over `recognizer.pad` (padding and casts), the program's
        own, `recognizer.rescore` (the hotword / LM pass) and
        `recognizer.decode` (the results, on the host)."""
        with profiling.annotate("recognizer.transcribe"):
            return self._transcribe(wavs, hotwords)

    def _transcribe(self, wavs, hotwords) -> List[TranscribeResult]:
        if not isinstance(wavs, (list, tuple)):
            wavs = [wavs]
        n_pos = len(self._positions)
        with profiling.annotate("recognizer.pad"):
            batch, lens = self.bucketer.pad_batch(
                [np.asarray(w) for w in wavs], batch_multiple=n_pos)
            t0 = time.perf_counter()
            batch = np.asarray(batch, np.float32)
            if self._int16_transfer:
                batch = to_int16_pcm(batch)
        want_logits = bool(hotwords) or self.lm is not None
        per = batch.shape[0] // n_pos
        t_lfr, k_max = self._bucket_shapes(batch.shape[1])

        def fetch(dev):
            # one small device → host fetch for all per-token outputs; the
            # rescoring inputs are copied out on the device only when needed
            kept = ({k: dev[k].clone() for k in self._RESCORING_INPUTS}
                    if want_logits and dev["packed"].is_cuda else dev)
            return to_host(dev["packed"]), kept

        self.forwards.add(n_pos)
        # every position's replay and fetch queued, then waited on
        shards = [self._fn_for(per, batch.shape[1], i)(
            batch[i * per:(i + 1) * per], lens[i * per:(i + 1) * per],
            read=fetch) for i in range(n_pos)]
        packed = np.concatenate([wait() for wait, _ in shards])
        out = {
            "token_count": packed[:, 0].astype(np.int32),
            "tokens": packed[:, 1: 1 + k_max].astype(np.int32),
            "token_center": packed[:, 1 + k_max: 1 + 2 * k_max],
            "token_start": packed[:, 1 + 2 * k_max: 1 + 3 * k_max],
            "fire_frame": packed[:, 1 + 3 * k_max: 1 + 4 * k_max],
        }
        if self.has_bicif:
            out["us_start"] = packed[:, 1 + 4 * k_max: 1 + 5 * k_max]
            out["us_end"] = packed[:, 1 + 5 * k_max: 1 + 6 * k_max]
        logits_np = None
        if want_logits and int(out["token_count"].max()) > 0:
            with profiling.annotate("recognizer.rescore"):
                kb = self.K_BUCKET
                k_b = min(-(-int(out["token_count"].max()) // kb) * kb, k_max)
                self.rescorings.add(n_pos)
                waits = [self._logits_fn(per, t_lfr, k_b, i)(
                    *(dev[k] for k in self._RESCORING_INPUTS),
                    read=lambda lg: to_host(lg.float()))
                    for i, (_, dev) in enumerate(shards)]
                logits_np = np.concatenate([wait() for wait in waits])
        proc_s = time.perf_counter() - t0
        timing_log("offline_asr_batch", proc_s * 1000)
        sr = self.fe_cfg.sample_rate
        audio_s = float(lens.sum()) / sr
        rtf = real_time_factor(proc_s, audio_s, label=f"b{len(wavs)}")
        results = []
        with profiling.annotate("recognizer.decode"):
            for i in range(len(wavs)):
                n = int(out["token_count"][i])
                ids = out["tokens"][i, :n].tolist()
                if n and logits_np is not None:
                    from scipy.special import log_softmax
                    logp = log_softmax(
                        logits_np[i, :n].astype(np.float64), axis=-1)
                    if self.lm is not None:
                        from .ngram_lm import lm_rescore
                        ids = lm_rescore(ids, logp, self.lm,
                                         self.tokenizer.tokens, self.lm_weight)
                    if hotwords:
                        from .hotword_bias import apply_hotword_bias
                        ids = apply_hotword_bias(ids, logp, hotwords,
                                                 self.tokenizer.token_to_id)
                toks = self.tokenizer.ids_to_tokens(ids)
                # refined timestamps: CIF center of mass of each token's window
                ts = (out["token_center"][i, :n].astype(np.float64)
                      * self.frame_ms).astype(int).tolist()
                # FunASR-style [start_ms, end_ms] intervals per token
                if self.has_bicif:
                    # BiCIF boundaries at 20 ms; FunASR caps a token at 30
                    # upsampled frames (600 ms)
                    starts = out["us_start"][i, :n] * self.us_ms
                    ends = (out["us_end"][i, :n] + 1) * self.us_ms
                    ends = np.minimum(ends, starts + 600.0)
                    spans = list(zip(starts.astype(int).tolist(),
                                     ends.astype(int).tolist()))
                else:
                    spans = list(zip(
                        (out["token_start"][i, :n] * self.frame_ms).astype(int)
                        .tolist(),
                        ((out["fire_frame"][i, :n] + 1) * self.frame_ms)
                        .astype(int).tolist()))
                results.append(TranscribeResult(
                    text=self.tokenizer.ids_to_text(ids),
                    tokens=toks,
                    token_ids=ids,
                    timestamps_ms=ts,
                    timestamp=spans,
                    audio_s=float(lens[i]) / sr,
                    rtf=rtf,
                ))
        return results

    def warmup_rescoring(self, batch: int, n_samples: int,
                         k_b: Optional[int] = None) -> None:
        """Build the phase-2 re-decode program of one bucket and replay it
        once on zeros, so the first live hotword/LM request finds it ready
        (a trained predictor fires no token on the silence a warm-up
        transcribes, so `transcribe` alone never reaches it)."""
        t_lfr, k_max = self._bucket_shapes(self.bucketer.bucket(n_samples))
        k_b = min(k_b or self.K_BUCKET, k_max)
        n_pos = len(self._positions)
        per = -(-batch // n_pos)   # the batch pads to the mesh, as served
        for i, owner in enumerate(self._positions):
            prog = self._logits_fn(per, t_lfr, k_b, i)
            self.rescorings.add()
            prog(*(torch.zeros(s, dtype=dt, device=owner.device)
                   for s, dt in prog.specs), read=lambda lg: None)

    def transcribe_file(self, path: str) -> TranscribeResult:
        from ..utils.audio import ensure_mono_16k, read_wav
        x, sr = read_wav(path)
        wav = ensure_mono_16k(x, sr, self.fe_cfg.sample_rate)
        return self.transcribe([wav])[0]

    # --------------------------------------------------------- long audio
    def split_long(self, wav: np.ndarray) -> List[Tuple[int, np.ndarray]]:
        """Silence-aware split of arbitrary-length audio into pieces that
        fit the bucket envelope. Each cut lands on the quietest 25 ms frame
        inside the window [½·max_bucket, max_bucket] past the previous cut.
        Returns [(start_sample, piece)]."""
        max_piece = self.bucketer.sizes[-1]
        if len(wav) <= max_piece:
            return [(0, np.asarray(wav, np.float32))]
        win = int(0.025 * self.fe_cfg.sample_rate)
        n_fr = len(wav) // win
        frame_rms = np.sqrt(
            np.mean(np.square(wav[:n_fr * win].reshape(n_fr, win)
                              .astype(np.float64)), axis=1))
        pieces = []
        pos = 0
        while len(wav) - pos > max_piece:
            lo = (pos + max_piece // 2) // win
            hi = min((pos + max_piece) // win, n_fr) - 1
            if hi > lo:
                window = frame_rms[lo:hi]
                # cut at the CENTER of the quietest run, not its first
                # frame, so both sides of the cut sit inside the pause
                quiet = window <= window.min() + 1e-9
                runs = np.flatnonzero(quiet)
                best = np.argmin(window)
                run = runs[(runs >= best)]
                run = run[np.r_[True, np.diff(run) == 1].cumprod().astype(
                    bool)]
                cut = int(lo + (run[0] + run[-1]) // 2) * win
            else:
                cut = pos + max_piece
            pieces.append((pos, np.asarray(wav[pos:cut], np.float32)))
            pos = cut
        pieces.append((pos, np.asarray(wav[pos:], np.float32)))
        return pieces

    def transcribe_long(self, wav: np.ndarray,
                        hotwords: Optional[dict] = None) -> TranscribeResult:
        """Arbitrary-length audio → ONE result with absolute timestamps:
        split at the quietest frames, batch-transcribe the pieces (rescoring
        included), and merge tokens and piece-offset timestamps."""
        pieces = self.split_long(np.asarray(wav, np.float32))
        if len(pieces) == 1:
            return self.transcribe([pieces[0][1]], hotwords=hotwords)[0]
        results = self.transcribe([p for _, p in pieces], hotwords=hotwords)
        sr = self.fe_cfg.sample_rate
        merged = TranscribeResult(text="", tokens=[], token_ids=[],
                                  timestamps_ms=[], timestamp=[],
                                  audio_s=len(wav) / sr,
                                  rtf=results[0].rtf)
        for (start, piece), r in zip(pieces, results):
            off = int(start * 1000 / sr)
            # the CIF tail-threshold fire can place the LAST token's center
            # slightly past the piece's valid frames — clamp to the piece
            # span so merged timestamps stay monotonic across cuts
            dur = int(len(piece) * 1000 / sr)
            merged.text += r.text
            merged.tokens += r.tokens
            merged.token_ids += r.token_ids
            merged.timestamps_ms += [min(t, dur) + off
                                     for t in r.timestamps_ms]
            merged.timestamp += [(min(s, dur) + off, min(e, dur) + off)
                                 for s, e in (r.timestamp or [])]
        return merged
