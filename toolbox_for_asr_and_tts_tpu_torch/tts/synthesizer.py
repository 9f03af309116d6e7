"""TTS synthesis pipeline: text → segments → phonemes → mel → waveform.

Port of `toolbox_for_asr_and_tts_tpu/tts/synthesizer.py` on the card:

- one device call per (batch, phone bucket, mel length): Sambert (NAR
  `forward` or PNCA `forward_ar`) → HiFi-GAN → int16 PCM on the card, with
  the mel lengths packed into the same int16 tensor, so one fetch brings a
  group's audio and lengths back;
- a job's segments are synthesized as padded batches of up to
  `TTSConfig.batch_size` rows;
- two-phase synthesis (TTS_TWO_PHASE, default on): a duration probe
  first, then mel lengths rounded up to `MEL_BUCKET` frames, so the
  decoder and vocoder do not run the L·frames_per_phone worst case;
  single-phase (TTS_TWO_PHASE=0) runs no probe and decodes and vocodes
  every row of a phone group at that worst case, in one mel group;
- crossfade and pause concatenation stay on the host (`tts/concat.py`).

Knobs read at construction: TTS_DECODER (`nar`, the default, or `pnca`)
and TTS_TWO_PHASE (on for "1" or "true", the default "1") from the
environment, as the reference reads them, and the two groupings
TTS_GROUP_BY_LENGTH (one call per phone bucket) and TTS_MEL_GROUP (one
call per mel bucket) from the environment, else the dispatch profile
(`runtime/autotune.py::env_or_profile`), as the reference resolves them;
the profile's `cuda` values were measured on the card (PERF.md §6).

`Synthesizer.from_model_dir` loads a mounted KAN-TTS package
(`scan_tts_package`), converting each checkpoint once into a
`<ckpt>.torch.npz` cache beside it (with its config in
`<ckpt>.torch.cfg.json`).

`use_mesh=True` synthesizes over `runtime/mesh.py::serving_mesh()`, as the
reference's: a group's rows pad up to a multiple of the positions (padding
rows yield no segment), each position runs its block of rows through its
own probe and synthesis programs on its device's replica of the weights,
and mel grouping (TTS_MEL_GROUP) applies only without a mesh.

The duration probe and the synthesis are programs (`runtime/graphs.py`)
keyed as the reference keys its compiled functions: a probe per (b, l), a
synthesis per (decoder, b, l, t_mel). On the card each is a captured CUDA
graph; in PNCA mode the whole AR scan of ⌈t_mel / r⌉ steps is inside the
synthesis graph.

Spans (`runtime/profiling.py`): `synth.segments` (one
`synthesize_segments` call) over `synth.probe` (a phone group's duration
probe: staging, replay and fetch) and `synth.group` (one mel group's
synthesis: staging, replay and fetch), each over the programs' own spans;
`synth.concat` (`StreamingConcat.feed` and `flush` in
`synthesize_stream`).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import hifigan, sambert
from ..models.convert import params_from_numpy, tree_to
from ..runtime import checkpoints as ckpt
from ..runtime import profiling
from ..runtime.bucketing import Bucketer
from ..runtime.config import TTSConfig
from ..runtime.graphs import Program, Programs, to_host
from ..runtime.mesh import per_position, serving_mesh
from ..runtime.metrics import Tally, real_time_factor, timing_log
from .concat import StreamingConcat, concat_segments
from .text_frontend import (G2P, LingVocab, pause_after, split_text_for_tts,
                            text_to_ling_ids)

logger = logging.getLogger("toolbox.tts")

PHONE_BUCKETS = (16, 32, 48, 64, 96, 128)

VOICES = ("zhitian_emo", "zhizhe_emo", "zhiyan_emo", "zhibei_emo")

CACHE_SUFFIX = ".torch.npz"          # converted tree beside a checkpoint
CFG_SUFFIX = ".torch.cfg.json"       # its pinned config


def scan_tts_package(model_dir: str, voice: str
                     ) -> Tuple[Optional[str], Optional[str]]:
    """Locate the (acoustic, vocoder) torch checkpoints in a mounted
    ModelScope sambert-hifigan package.

    KAN-TTS packages keep per-voice checkpoints under e.g.
    `voices/<voice>/am/ckpt/checkpoint_*.pth` and `…/voc/ckpt/…`, with base
    models under `basemodel_16k/{sambert,hifigan}` — the exact nesting
    varies by package revision, so this scans by path tokens: a path segment
    equal to `voc`/containing `hifigan|vocoder` marks the vocoder, one equal
    to `am`/containing `sambert|acoustic` the acoustic model. Among
    candidates, the requested voice's path wins, then the highest checkpoint
    step number. A port cache (`<ckpt>.torch.npz`) whose checkpoint was
    deleted stands for it; the reference's `.jax.npz` caches are ignored."""
    am, voc = [], []
    for root, _, files in os.walk(model_dir):
        for f in files:
            if f.endswith(CACHE_SUFFIX):
                # converted cache without its source ckpt still loads:
                # report the (deleted) source path the cache sits next to
                f = f[:-len(CACHE_SUFFIX)]
                if f in files:
                    continue
            elif not f.endswith((".pth", ".pt", ".bin")):
                continue
            p = os.path.join(root, f)
            segs = [s.lower() for s in
                    os.path.relpath(p, model_dir).split(os.sep)]
            if any(s == "voc" or "hifigan" in s or "vocoder" in s
                   for s in segs):
                voc.append(p)
            elif any(s == "am" or "sambert" in s or "acoustic" in s
                     for s in segs):
                am.append(p)

    def pick(cands):
        if not cands:
            return None

        def score(p):
            nums = re.findall(r"(\d+)", os.path.basename(p))
            return (voice.lower() in p.lower(),
                    int(nums[-1]) if nums else -1)

        return max(cands, key=score)

    return pick(am), pick(voc)


def _nearest_config(ckpt_path: str, model_dir: str) -> dict:
    """The config file closest to a checkpoint, walking up to the package
    root (KAN-TTS keeps `config.yaml` next to each ckpt dir)."""
    d = os.path.dirname(os.path.abspath(ckpt_path))
    top = os.path.abspath(model_dir)
    while True:
        conf = ckpt.load_model_config(d)
        if conf:
            return conf
        if d == top:
            return {}
        parent = os.path.dirname(d)
        if parent == d:
            return {}
        d = parent


def _load_checkpoint(path: str, model_dir: str, cfg_cls, from_conf,
                     pin_from_sd, init, rules_for, keep_missing: bool = False,
                     pre_transform=None):
    """One TTS checkpoint → (cfg, tree with numpy leaves): from its
    `.torch.npz` cache when that exists and is not older than the
    checkpoint, else converted (geometry from the nearest config, then
    pinned from the state dict's shapes) and cached. `init(g, cfg)` builds
    the family's tree; with keep_missing its leaves that the checkpoint
    lacks keep a CPU draw of seed 0."""
    cache, cfg_f = path + CACHE_SUFFIX, path + CFG_SUFFIX
    fresh = os.path.exists(cache) and os.path.exists(cfg_f) and not (
        os.path.exists(path)
        and os.path.getmtime(path) > os.path.getmtime(cache))
    if fresh:
        with open(cfg_f, encoding="utf-8") as f:
            raw = json.load(f)
        fixed = {k: tuple(tuple(x) if isinstance(x, list) else x
                          for x in v) if isinstance(v, list) else v
                 for k, v in raw.items()}
        cfg = cfg_cls(**fixed)
        return cfg, ckpt.load_converted(
            cache, ckpt.shape_template(lambda g: init(g, cfg)))
    sd = ckpt.load_torch_state_dict(path)
    if pre_transform is not None:
        sd = pre_transform(sd)
    cfg = pin_from_sd(sd, from_conf(_nearest_config(path, model_dir)))
    if keep_missing:
        template = init(torch.Generator().manual_seed(0), cfg)
    else:
        template = ckpt.shape_template(lambda g: init(g, cfg))
    params = ckpt.convert_state_dict(sd, rules_for(cfg), template,
                                     keep_missing=keep_missing)
    del sd
    try:
        ckpt.save_converted(cache, params)
        with open(cfg_f, "w", encoding="utf-8") as f:
            json.dump(dataclasses.asdict(cfg), f)
    except OSError:   # read-only package — conversion still works
        logger.warning("could not cache converted TTS params at %s", cache)
    return cfg, params


@dataclasses.dataclass
class SynthesisResult:
    wav: np.ndarray
    sample_rate: int
    segments: List[str]
    seg_times_ms: List[float]
    seg_durations_s: List[float]
    rtf: float


class Synthesizer:
    MEL_BUCKET = 64  # t_mel granularity of the two-phase path

    def __init__(self, acoustic_params, acoustic_cfg: sambert.SambertConfig,
                 vocoder_params, vocoder_cfg: hifigan.HifiGanConfig,
                 g2p: Optional[G2P] = None,
                 vocab: Optional[LingVocab] = None,
                 tts_cfg: Optional[TTSConfig] = None,
                 voices: Sequence[str] = VOICES,
                 device: DeviceLike = None,
                 param_dtype: Optional[torch.dtype] = None,
                 use_mesh: bool = False):
        """device: the card unless "cpu" is passed; param_dtype: the
        floating leaves' dtype of both trees (torch.bfloat16 halves the
        weights; products and convolutions still run in f32); use_mesh:
        synthesize over `serving_mesh(device=device)` (`self.device` is
        then its first position)."""
        self.device = resolve_device(device)
        self.mesh = serving_mesh(device=self.device) if use_mesh else None
        positions = (self.mesh.positions() if self.mesh is not None
                     else [self.device])
        self.device = positions[0]
        self.ap = tree_to(acoustic_params, self.device, param_dtype)
        self.vp = tree_to(vocoder_params, self.device, param_dtype)
        # (ap, vp) per mesh position, one copy per distinct device
        self._replicas = list(zip(per_position(self.ap, positions),
                                  per_position(self.vp, positions)))
        self.acfg, self.vcfg = acoustic_cfg, vocoder_cfg
        self.g2p = g2p or G2P()
        self.vocab = vocab or LingVocab.default()
        self.cfg = tts_cfg or TTSConfig()
        self.voice_to_id = {v: i % acoustic_cfg.n_speakers
                            for i, v in enumerate(voices)}
        # dispatch-bound knobs: an explicit env var wins, else the profile
        from ..runtime.autotune import env_or_profile
        self.group_by_length = env_or_profile("TTS_GROUP_BY_LENGTH",
                                              "tts_group_by_length")
        # "nar" (fast mode, default) or "pnca" (KAN-TTS AR decoder — the
        # weight-compatible path for real zhitian_emo checkpoints)
        self.decoder_mode = os.getenv("TTS_DECODER", "nar")
        self.two_phase = os.getenv("TTS_TWO_PHASE", "1") in ("1", "true")
        self.mel_group = env_or_profile("TTS_MEL_GROUP", "tts_mel_group")
        self.bucketer = Bucketer(PHONE_BUCKETS)
        self.sample_rate = self.cfg.sampling_rate
        # telemetry: the device programs run (duration probes, synth
        # groups), the PNCA decoder's steps, the mel frames (padding
        # included) that the decoder and vocoder computed, and the valid
        # ones among them (the segments' mel lengths)
        self.probes = Tally()
        self.synths = Tally()
        self.ar_steps = Tally()
        self.mel_frames = Tally()
        self.mel_frames_valid = Tally()
        # one program per probe and synthesis bucket; on the card a graph
        self._positions = [Programs(dev, "synthesizer" if i == 0
                                    else f"synthesizer@{i}")
                           for i, dev in enumerate(positions)]
        self.programs = self._positions[0]

    @classmethod
    def random(cls, seed: int = 0, tiny: bool = True,
               device: DeviceLike = None, **kw) -> "Synthesizer":
        """Random weights drawn on `device` from `seed`: the reference's
        test geometry (`tiny`) or the full width its TTS app serves without
        a checkpoint (Sambert d 256, 4 + 4 layers, 6 PNCA layers; HiFi-GAN
        512 channels, upsample (5, 5, 4, 2)). A card draw and a CPU draw of
        one seed differ; copy `ap` / `vp` to compare devices."""
        dev = resolve_device(device)
        vocab = LingVocab.default()
        if tiny:
            acfg = sambert.SambertConfig(
                vocab_size=len(vocab), d_model=32, n_heads=2, ffn_dim=64,
                encoder_layers=1, decoder_layers=1, var_channels=32,
                postnet_channels=32, frames_per_phone=8)
            vcfg = hifigan.HifiGanConfig(
                upsample_initial_channel=32, upsample_rates=(5, 5, 4, 2),
                upsample_kernels=(11, 11, 8, 4), resblock_kernels=(3,),
                resblock_dilations=((1, 3),))
        else:
            acfg = sambert.SambertConfig(vocab_size=len(vocab))
            vcfg = hifigan.HifiGanConfig()
        g = torch.Generator(device=dev).manual_seed(seed)
        return cls(sambert.init_params(g, acfg), acfg,
                   hifigan.init_params(g, vcfg), vcfg, vocab=vocab,
                   device=dev, **kw)

    @classmethod
    def from_model_dir(cls, model_dir: str, voice: str = "zhitian_emo",
                       device: DeviceLike = None, **kw) -> "Synthesizer":
        """Load a mounted `speech_sambert-hifigan_tts_zh-cn_16k` package onto
        `device` (the card unless "cpu" is passed): scan the KAN-TTS layout
        for the voice's acoustic + vocoder checkpoints, pin geometry from
        each checkpoint's own config file and its tensor shapes, convert
        through the `runtime/checkpoints.py` name maps (Sambert's BatchNorm
        postnet folded, its framework-only NAR decoder kept from a seed-0
        draw; HiFi-GAN's weight norm folded), and default to the
        weight-compatible PNCA decoder unless TTS_DECODER is set."""
        am_path, voc_path = scan_tts_package(model_dir, voice)
        if am_path is None or voc_path is None:
            raise FileNotFoundError(
                f"no acoustic/vocoder checkpoint pair under {model_dir} "
                f"(am={am_path}, voc={voc_path})")
        dev = resolve_device(device)
        acfg, ap = _load_checkpoint(
            am_path, model_dir, sambert.SambertConfig,
            sambert.SambertConfig.from_kantts, sambert.config_from_state_dict,
            sambert.init_params,
            lambda c: ckpt.sambert_rules(c.encoder_layers, c.pnca_layers,
                                         c.postnet_layers),
            keep_missing=True,   # the NAR fast-mode decoder is framework-only
            pre_transform=ckpt.fold_batch_norm)   # the real postnet is BN
        ap = params_from_numpy(ap, dev)
        vcfg, vp = _load_checkpoint(
            voc_path, model_dir, hifigan.HifiGanConfig,
            hifigan.HifiGanConfig.from_config, hifigan.config_from_state_dict,
            hifigan.init_params,
            lambda c: ckpt.hifigan_rules(len(c.upsample_rates),
                                         len(c.resblock_kernels),
                                         len(c.resblock_dilations[0])),
            pre_transform=ckpt.fold_weight_norm)
        vp = params_from_numpy(vp, dev)
        logger.info("TTS checkpoints loaded: am=%s (%d phones, %dL enc/%dL "
                    "pnca) voc=%s (hop %d)", am_path, acfg.vocab_size,
                    acfg.encoder_layers, acfg.pnca_layers, voc_path,
                    vcfg.hop_length)
        synth = cls(ap, acfg, vp, vcfg, device=dev, **kw)
        if len(synth.vocab) != acfg.vocab_size:
            # the package's phone inventory and the front end's must be
            # reconciled symbol by symbol; a size drift means ids would
            # address the wrong embedding rows
            logger.warning(
                "frontend phone vocab (%d) != checkpoint embedding rows (%d)"
                " — map the package's phone list onto tts/pinyin_data.py or "
                "pass vocab= explicitly", len(synth.vocab), acfg.vocab_size)
        if "TTS_DECODER" not in os.environ:
            # real checkpoints only map onto the PNCA AR decoder
            synth.decoder_mode = "pnca"
        return synth

    # ------------------------------------------------------ device programs
    def _synth(self, ids: torch.Tensor, lens: torch.Tensor,
               spk: torch.Tensor, t_mel: int, pnca: bool,
               pos: int = 0) -> torch.Tensor:
        """Acoustic model → vocoder → int16 PCM for a [b, l] phone batch:
        returns one int16 tensor [b, t_mel·hop + 1] whose last column holds
        the mel lengths (≤ t_mel < 2^15), so one fetch brings both back."""
        acfg = self.acfg
        if t_mel + acfg.outputs_per_step >= 1 << 15:
            raise ValueError(f"t_mel {t_mel} does not fit the int16 fetch")
        acoustic = sambert.forward_ar if pnca else sambert.forward
        ap, vp = self._replicas[pos]
        out = acoustic(ap, ids, lens, spk, acfg, t_mel=t_mel)
        wav = hifigan.forward(vp, out["mel"], self.vcfg)
        # int16 on the card: the final PCM format, and half the bytes of
        # the f32 waveform to fetch
        pcm = torch.clamp(torch.round(wav * 32767.0), -32768, 32767)
        return torch.cat([pcm.to(torch.int16),
                          out["mel_lens"][:, None].to(torch.int16)], 1)

    @torch.inference_mode()
    def _dur_fn(self, ids: torch.Tensor, lens: torch.Tensor,
                spk: torch.Tensor, pos: int = 0) -> torch.Tensor:
        """The duration probe of a [b, l] batch → mel frame counts [b]."""
        return sambert.predict_mel_lens(self._replicas[pos][0], ids, lens,
                                        spk, self.acfg)

    def _batch_specs(self, b: int, l: int):
        return [((b, l, 4), torch.int32), ((b,), torch.int32),
                ((b,), torch.int32)]

    def _synth_prog(self, b: int, l: int, t_mel: int,
                    pos: int = 0) -> Program:
        """The synthesis program of one (decoder, b, l, t_mel) bucket on
        mesh position `pos`."""
        pnca = self.decoder_mode == "pnca"

        def build():
            return ((lambda i, n, s: self._synth(i, n, s, t_mel, pnca, pos)),
                    self._batch_specs(b, l))
        return self._positions[pos].get(
            ("synth", self.decoder_mode, b, l, t_mel), build)

    def _dur_prog(self, b: int, l: int, pos: int = 0) -> Program:
        """The duration probe program of one (b, l) bucket on mesh
        position `pos`."""
        def build():
            return ((lambda i, n, s: self._dur_fn(i, n, s, pos)),
                    self._batch_specs(b, l))
        return self._positions[pos].get(("dur", b, l), build)

    def _sharded(self, prog_for, *arrays: np.ndarray) -> np.ndarray:
        """Run `prog_for(rows per position, position)` on each position's
        block of rows of `arrays`, every fetch queued before any wait, and
        join the fetched outputs in row order."""
        n_pos = len(self._positions)
        per = arrays[0].shape[0] // n_pos
        waits = [prog_for(per, i)(*(a[i * per:(i + 1) * per] for a in arrays),
                                  read=to_host) for i in range(n_pos)]
        return np.concatenate([wait() for wait in waits])

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    # ------------------------------------------------------------ public
    def synthesize_segments(self, segments: Sequence[str], voice: str
                            ) -> Tuple[List[np.ndarray], List[float]]:
        """Batch-synthesize text segments → per-segment waveforms, in the
        order given. With TTS_GROUP_BY_LENGTH, one call per phone bucket;
        else one call for the whole batch at the longest row's bucket."""
        with profiling.annotate("synth.segments"):
            return self._synthesize_segments(segments, voice)

    def _synthesize_segments(self, segments: Sequence[str], voice: str
                             ) -> Tuple[List[np.ndarray], List[float]]:
        spk_id = self.voice_to_id.get(voice, 0)
        ids_list = [text_to_ling_ids(s, self.g2p, self.vocab)
                    for s in segments]
        groups: Dict[int, List[int]] = {}
        if self.group_by_length:
            for idx, seq in enumerate(ids_list):
                groups.setdefault(self.bucketer.bucket(max(len(seq), 1)),
                                  []).append(idx)
        else:
            l_all = self.bucketer.bucket(
                max(max((len(s) for s in ids_list), default=1), 1))
            groups[l_all] = list(range(len(ids_list)))
        hop = self.vcfg.hop_length
        wavs: List[Optional[np.ndarray]] = [None] * len(segments)
        durs: List[float] = [0.0] * len(segments)
        t0 = time.perf_counter()
        n_pos = len(self._positions)
        for l, idxs in sorted(groups.items()):
            # exact batch rows (b ≤ batch_size): padded rows would
            # synthesize full-length garbage mels; on a mesh, rows pad up
            # to the positions so that each takes a block
            b = -(-len(idxs) // n_pos) * n_pos
            ids = np.zeros((b, l, 4), np.int32)
            lens = np.ones((b,), np.int32)
            for row, idx in enumerate(idxs):
                seq = ids_list[idx]
                n = min(len(seq), l)
                if n:
                    ids[row, :n] = np.asarray(seq[:n], np.int32)
                lens[row] = max(n, 1)
            spk = np.full((b,), spk_id, np.int32)
            # two-phase: the duration probe picks tight mel buckets; rows
            # regroup by predicted mel bucket under TTS_MEL_GROUP.
            # Single-phase: every row at the worst case, in one group
            t_cap = l * self.acfg.frames_per_phone
            mb = self.MEL_BUCKET
            mel_groups: Dict[int, List[int]] = {}
            if not self.two_phase:
                mel_groups[t_cap] = list(range(b))
            else:
                self.probes.add(n_pos)
                with profiling.annotate("synth.probe"):
                    probe = self._sharded(
                        lambda per, i: self._dur_prog(per, l, i), ids, lens,
                        spk)
                t_rows = np.minimum(-(-probe // mb) * mb, t_cap)
                t_rows = np.maximum(t_rows, mb).astype(int)
                if self.mel_group and self.mesh is None:
                    for row in range(b):
                        mel_groups.setdefault(int(t_rows[row]), []).append(row)
                else:
                    mel_groups[int(t_rows.max())] = list(range(b))
            for t_mel, rows in sorted(mel_groups.items()):
                n_prog = n_pos if self.mesh is not None else 1
                self.synths.add(n_prog)
                if self.decoder_mode == "pnca":
                    self.ar_steps.add(
                        n_prog * -(-t_mel // self.acfg.outputs_per_step))
                self.mel_frames.add(len(rows) * t_mel)
                with profiling.annotate("synth.group"):
                    packed = self._sharded(
                        lambda per, i: self._synth_prog(per, l, t_mel, i),
                        ids[rows], lens[rows], spk[rows])
                pcm, mel_lens = packed[:, :-1], packed[:, -1]
                for g_row, row in enumerate(rows):
                    if row >= len(idxs):
                        continue   # mesh padding: no segment behind it
                    idx = idxs[row]
                    self.mel_frames_valid.add(int(mel_lens[g_row]))
                    n = int(mel_lens[g_row]) * hop
                    wavs[idx] = pcm[g_row, :n].astype(np.float32) / 32767.0
                    durs[idx] = n / self.sample_rate
        timing_log("tts_batch_synthesis", (time.perf_counter() - t0) * 1000)
        return wavs, durs

    def synthesize(self, text: str, voice: str = "zhitian_emo",
                   cancelled=lambda: False) -> Optional[SynthesisResult]:
        """Full job: split → batch synth → pause/crossfade concat.

        `cancelled` is polled between stages (cooperative cancel); a
        cancelled job returns None."""
        segments = split_text_for_tts(text, self.cfg.seg_target,
                                      self.cfg.seg_first, self.cfg.seg_hard_max)
        if not segments:
            return SynthesisResult(np.zeros(0, np.float32), self.sample_rate,
                                   [], [], [], 0.0)
        if cancelled():
            return None
        t0 = time.perf_counter()
        seg_wavs: List[np.ndarray] = []
        seg_durs: List[float] = []
        seg_times: List[float] = []
        bs = max(1, self.cfg.batch_size)
        for i in range(0, len(segments), bs):
            if cancelled():
                return None
            ts = time.perf_counter()
            wavs, durs = self.synthesize_segments(segments[i:i + bs], voice)
            dt = (time.perf_counter() - ts) * 1000 / max(len(wavs), 1)
            seg_wavs += wavs
            seg_durs += durs
            seg_times += [dt] * len(wavs)
        pauses = [pause_after(s, self.cfg.pause_soft_ms, self.cfg.pause_hard_ms)
                  for s in segments[:-1]]
        wav = concat_segments(seg_wavs, pauses, self.sample_rate,
                              self.cfg.crossfade_ms)
        proc_s = time.perf_counter() - t0
        audio_s = len(wav) / self.sample_rate
        rtf = real_time_factor(proc_s, max(audio_s, 1e-6), label="tts_job")
        return SynthesisResult(wav, self.sample_rate, segments,
                               seg_times, seg_durs, rtf)

    def synthesize_stream(self, text: str, voice: str = "zhitian_emo",
                          cancelled=lambda: False):
        """Streaming job: yield audio chunks as segments finish.

        The first segment is synthesized alone (the cheapest first call),
        the rest in batches of `batch_size`, through an incremental
        crossfade/pause concatenator (`StreamingConcat`) that emits every
        sample once the next boundary can no longer change it. All chunks
        concatenated equal `synthesize()` exactly under per-segment
        grouping (TTS_GROUP_BY_LENGTH=1 and TTS_MEL_GROUP=1); under
        whole-batch grouping the first segment runs at its own padded
        shape, which may change float low bits.

        Yields dicts:
          {"event": "chunk", "audio": float32[n], "segment_index": i,
           "n_segments": N, "text": <segment>}        — per finished segment
          {"event": "done", "audio": <held tail>, "rtf": …,
           "duration_s": …, "segments": […], "seg_times_ms": […],
           "seg_durations_s": […]}                    — exactly once, last
        Returns early (no "done" event) when `cancelled()` turns true.
        """
        segments = split_text_for_tts(text, self.cfg.seg_target,
                                      self.cfg.seg_first,
                                      self.cfg.seg_hard_max)
        if not segments:
            yield {"event": "done", "audio": np.zeros(0, np.float32),
                   "rtf": 0.0, "duration_s": 0.0, "segments": [],
                   "seg_times_ms": [], "seg_durations_s": []}
            return
        pauses = [pause_after(s, self.cfg.pause_soft_ms,
                              self.cfg.pause_hard_ms)
                  for s in segments[:-1]]
        stream = StreamingConcat(self.sample_rate, self.cfg.crossfade_ms)
        t0 = time.perf_counter()
        emitted = 0
        seg_times: List[float] = []
        seg_durs: List[float] = []
        bs = max(1, self.cfg.batch_size)
        batches = [[segments[0]]]
        batches += [segments[i:i + bs] for i in range(1, len(segments), bs)]
        done = 0
        for batch in batches:
            if cancelled():
                return
            ts = time.perf_counter()
            wavs, durs = self.synthesize_segments(batch, voice)
            dt = (time.perf_counter() - ts) * 1000 / max(len(wavs), 1)
            seg_times += [dt] * len(wavs)
            seg_durs += durs
            for seg_text, w in zip(batch, wavs):
                fed = stream.segments_fed
                pause = pauses[fed - 1] if 1 <= fed <= len(pauses) else 0
                with profiling.annotate("synth.concat"):
                    chunk = stream.feed(w, pause)
                idx = done
                done += 1
                if len(chunk):
                    emitted += len(chunk)
                    yield {"event": "chunk", "audio": chunk,
                           "segment_index": idx, "n_segments": len(segments),
                           "text": seg_text}
        with profiling.annotate("synth.concat"):
            tail = stream.flush()
        emitted += len(tail)
        proc_s = time.perf_counter() - t0
        audio_s = emitted / self.sample_rate
        rtf = real_time_factor(proc_s, max(audio_s, 1e-6), label="tts_job")
        yield {"event": "done", "audio": tail, "rtf": rtf,
               "duration_s": audio_s, "segments": segments,
               "seg_times_ms": seg_times, "seg_durations_s": seg_durs}
