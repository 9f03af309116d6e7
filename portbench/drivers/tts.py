"""TTS paragraph jobs: a closed loop of clients over the service's job API
(`tts/jobs.py::TTSJobManager` over a `Synthesizer`).

Traffic parameters (`portbench/traffic/<name>.json`, "params"):
- clients: jobs in flight at once; each client submits
  `start_task(text, voice)`, polls `get_result` every `poll_s` until the
  job is done, then submits the next;
- voice: the voice every job asks for;
- paragraphs: how many texts the loop cycles through;
- chars: {"median", "sigma", "min", "max"}: a log-normal of the texts'
  lengths in characters, its quantiles, clipped;
- clause_chars: [lo, hi]: clause lengths, drawn uniformly; a clause ends in
  "。" with probability `sentence_share`, else in "，", the last in "。";
- layout_seed: the fixed draw of the texts (characters from the port's
  pinyin table);
- trace: {"after_s", "seconds"}: where the profile begins, and its length.

Every seed serves the same texts: they are laid out once from
`layout_seed`. The run's seed orders them and draws the weights.

Weights: the port's `init_params` for Sambert and HiFi-GAN drawn on the
card. The speech's timing is laid out once, as the texts are: the
embeddings, the encoder and the duration head (`TIMING`) are drawn from
`layout_seed`, the same in every run, and everything else from the run's
seed. Random durations otherwise differ from seed to seed in how they
spread within a segment group, and with them the mel padding and the work
per second of speech. Then two changes (the configuration's `assumed`):
- the duration head's output bias is set so that the median duration
  before rounding, over the phones of the texts' first
  `calibration_segments` segments, is `frames_per_phone` (the
  configuration's `duration_bias`): random weights otherwise set the speech
  rate, and with it the decoder's steps;
- HiFi-GAN's upsampling weights are scaled by √(6 · rate) (`vocoder_gain`),
  which keeps the signal's variance through each upsampling and its leaky
  ReLU: at the init's scale the random vocoder's output is a near-constant
  offset (a standard deviation of ≈ 0.003 of full scale) that a mel hardly
  moves.

Set-up synthesizes every text once through `synthesize_stream`, the
jobs' path, one text after another on the driver's thread: that captures
every program the traffic reaches, and no job worker competes with the
captures for the interpreter.

End-to-end: `audio_throughput`, seconds of speech in the WAVs of the jobs
completed in the window (pauses and crossfades as served) over the
window's wall time; the window ends when the last job started before the
deadline completes. The check judges `check.jobs` texts, each as last
served, against the reference.
"""
from __future__ import annotations

import base64
import math
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from portbench import check_tts  # noqa: E402
from portbench.reference import sambert_hifigan as ref  # noqa: E402

WAV_HEADER = 44     # bytes before the samples in the service's WAV
# the acoustic subtrees that set the durations, drawn from `layout_seed`
TIMING = ("ling", "spk", "emo", "encoder", "duration")


def layout(p: Dict) -> List[str]:
    """The texts, the same for every seed."""
    from toolbox_for_asr_and_tts_tpu_torch.tts.pinyin_data import \
        PINYIN_TABLE
    chars = sorted(k for k in PINYIN_TABLE if len(k) == 1)
    c, (lo, hi) = p["chars"], p["clause_chars"]
    n = p["paragraphs"]
    nd = statistics.NormalDist()
    lens = [int(min(max(round(c["median"] * math.exp(
        c["sigma"] * nd.inv_cdf((i + 0.5) / n))), c["min"]), c["max"]))
        for i in range(n)]
    rng = np.random.default_rng(p["layout_seed"])
    texts = []
    for total in lens:
        clauses: List[List] = []
        k = 0
        while k < total:
            m = min(int(rng.integers(lo, hi + 1)), total - k)
            if m < lo and clauses:
                clauses[-1][0] += m
            else:
                clauses.append([m, "。" if rng.random() < p["sentence_share"]
                                else "，"])
            k += m
        clauses[-1][1] = "。"
        texts.append("".join(
            "".join(chars[int(j)] for j in rng.integers(0, len(chars), m))
            + end for m, end in clauses))
    return texts


def configs(config: Dict):
    """(SambertConfig, HifiGanConfig) of the configuration file."""
    from toolbox_for_asr_and_tts_tpu_torch.models import hifigan, sambert
    v = {k: tuple(tuple(x) if isinstance(x, list) else x for x in val)
         if isinstance(val, list) else val
         for k, val in config["hifigan"].items()}
    return sambert.SambertConfig(**config["sambert"]), \
        hifigan.HifiGanConfig(**v)


def make_params(config: Dict, seed: int, device, calibration,
                timing_seed: int) -> tuple:
    """(acoustic tree, vocoder tree) drawn on `device`: the `TIMING`
    subtrees from `timing_seed`, the rest from `seed`; the duration bias
    set over `calibration` (phone id rows [L, 4])."""
    from toolbox_for_asr_and_tts_tpu_torch.models import hifigan, sambert
    acfg, vcfg = configs(config)
    g = torch.Generator(device=device).manual_seed(seed)
    ap = sambert.init_params(g, acfg)
    vp = hifigan.init_params(g, vcfg)
    timing = sambert.init_params(
        torch.Generator(device=device).manual_seed(timing_seed), acfg)
    ap.update({k: timing[k] for k in TIMING})
    if config.get("vocoder_gain") == "sqrt(6 * rate)":
        for up, rate in zip(vp["ups"], vcfg.upsample_rates):
            up["w"] = up["w"] * math.sqrt(6.0 * rate)
    out = ap["duration"]["out"]
    out["b"] = torch.zeros_like(out["b"])
    with torch.inference_mode():
        pre = torch.cat([ref.encode(ap, config["sambert"], torch.as_tensor(
            ids, device=device), 0, len(ids))[1] for ids in calibration])
    bias = math.log(config["duration_bias"]["frames_per_phone"] + 1.0) \
        - float(pre.median())
    out["b"] = torch.full_like(out["b"], bias)
    return ap, vp


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config = config
        self.p = traffic["params"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.attempted = self.failed = 0
        svc = config["service"]
        self.sr = svc["sampling_rate"]
        self.hop = math.prod(config["hifigan"]["upsample_rates"])
        self.texts = layout(self.p)
        from toolbox_for_asr_and_tts_tpu_torch.tts.text_frontend import (
            G2P, LingVocab, pause_after, split_text_for_tts,
            text_to_ling_ids)
        g2p, vocab = G2P(), LingVocab.default()
        self.segments = [split_text_for_tts(t, svc["seg_target"],
                                            svc["seg_first"],
                                            svc["seg_hard_max"])
                         for t in self.texts]
        self.ids = [[text_to_ling_ids(s, g2p, vocab) for s in segs]
                    for segs in self.segments]
        self.pauses = [[pause_after(s, svc["pause_soft_ms"],
                                    svc["pause_hard_ms"]) for s in segs[:-1]]
                       for segs in self.segments]
        n = config["duration_bias"]["calibration_segments"]
        self.calibration = [x for ids in self.ids for x in ids][:n]

    # ------------------------------------------------------------ set-up
    def _synthesizer(self, ap, vp):
        from toolbox_for_asr_and_tts_tpu_torch.runtime.config import TTSConfig
        from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import \
            Synthesizer
        svc = self.config["service"]
        acfg, vcfg = configs(self.config)
        tts = TTSConfig(**{k: svc[k] for k in (
            "batch_size", "seg_target", "seg_first", "seg_hard_max",
            "crossfade_ms", "pause_soft_ms", "pause_hard_ms",
            "sampling_rate", "max_concurrent_jobs")})
        synth = Synthesizer(ap, acfg, vp, vcfg, tts_cfg=tts,
                            device=self.device)
        # as `from_model_dir` leaves it for a mounted KAN-TTS package
        synth.decoder_mode = svc["decoder_mode"]
        if synth.two_phase != svc["two_phase"]:
            raise RuntimeError("TTS_TWO_PHASE differs from the configuration")
        return synth

    def setup(self, seconds: float) -> None:
        from toolbox_for_asr_and_tts_tpu_torch.tts.jobs import TTSJobManager
        t = time.perf_counter()
        ap, vp = make_params(self.config, self.seed, self.device,
                             self.calibration, self.p["layout_seed"])
        self.synth = self._synthesizer(ap, vp)
        self.jobs = TTSJobManager(self.synth,
                                  max_workers=self.config["service"]
                                  ["max_concurrent_jobs"], job_ttl_s=0)
        order = np.random.default_rng(self.seed).permutation(len(self.texts))
        self.order = [int(i) for i in order]
        self.phases = {"weights, synthesizer": time.perf_counter() - t}
        t = time.perf_counter()
        # every text once: every program the traffic reaches is captured
        for i in self.order:
            for _ in self.synth.synthesize_stream(self.texts[i],
                                                  self.p["voice"]):
                pass
        self.phases["warm-up and captures"] = time.perf_counter() - t
        self._captures0 = self._captures()
        progs = self.synth.programs
        self.phases.update(programs=len(progs), capture_s=progs.capture_s,
                           pool_gib=(progs.pool_bytes() or 0) / 2 ** 30)

    def _captures(self) -> int:
        from toolbox_for_asr_and_tts_tpu_torch.runtime import graphs
        return sum(o["captures"] for o in graphs.report())

    def counters(self) -> Dict[str, int]:
        """The synthesizer's tallies (those this program has)."""
        out = {}
        for name in ("probes", "synths", "ar_steps", "mel_frames",
                     "mel_frames_valid"):
            tally = getattr(self.synth, name, None)
            if tally is not None:
                out[name] = tally.n
        return out

    def _replays(self) -> Dict:
        progs = self.synth.programs
        return {key: progs.get(key, None).replays for key in progs}

    # ------------------------------------------------------------ window
    def _trace(self, tracer, now: float, trace_at: float) -> None:
        """Begin and end the profile under the synthesizer's replay lock,
        reading each program's replays there: the replays counted between
        the two readings ran wholly inside the profile."""
        lock = self.synth.programs.lock
        if not tracer.recorded and not tracer.recording and now >= trace_at:
            with lock:
                tracer.begin(self.p["trace"]["seconds"])
                if tracer.recording:
                    self._at_begin = self._replays()
        elif tracer.recording and time.perf_counter() >= tracer.until:
            with lock:
                tracer.stop()
                self._at_stop = self._replays()

    def window(self, seconds: float, tracer) -> None:
        p = self.p
        self.calls: List[Dict] = []
        self.served: Dict[int, Dict] = {}     # each text as last served
        self._at_begin = self._at_stop = None
        self.done: List[int] = []
        audio_s, k = 0.0, 0
        slots: List[Optional[tuple]] = [None] * p["clients"]
        t0 = time.perf_counter()
        end = t0 + seconds
        trace_at = t0 + min(p["trace"]["after_s"], 0.25 * seconds)
        t_last = t0
        while True:
            now = time.perf_counter()
            self._trace(tracer, now, trace_at)
            for c, slot in enumerate(slots):
                if slot is None:
                    if now < end:
                        i = self.order[k % len(self.order)]
                        k += 1
                        slots[c] = (i, self.jobs.start_task(self.texts[i],
                                                            p["voice"]))
                        self.attempted += 1
                    continue
                i, jid = slot
                r = self.jobs.get_result(jid)
                if r["status"] in ("pending", "processing"):
                    continue
                self.jobs.cleanup_job(jid)
                slots[c] = None
                t_last = time.perf_counter()
                if r["status"] != "completed":
                    self.failed += 1
                    continue
                pcm = np.frombuffer(base64.b64decode(r["audio_base64"]),
                                    "<i2", offset=WAV_HEADER)
                audio_s += len(pcm) / self.sr
                lens = check_tts.mel_lengths(
                    r["detailed_timing"]["seg_durations_s"], self.sr,
                    self.hop)
                self.served[i] = {"pcm": pcm, "mel_lens": lens}
                self.calls += self._plan(i, lens)
                self.done.append(i)
            if now >= end and all(s is None for s in slots):
                break
            time.sleep(p["poll_s"])
        if tracer.recording:
            with self.synth.programs.lock:
                tracer.stop()
                self._at_stop = self._replays()
        self.window_s = t_last - t0 - tracer.overhead_s
        self.audio_s = audio_s
        self.captures_window = self._captures() - self._captures0
        if self._at_begin is not None and self._at_stop is not None:
            for key, n in self._at_stop.items():
                n -= self._at_begin.get(key, 0)
                if n:
                    self.calls.append({"kind": "replay", "key": list(key),
                                       "replays": n, "traced": True})

    def _knobs(self) -> Dict:
        s = self.synth
        return {"batch_size": s.cfg.batch_size,
                "group_by_length": s.group_by_length,
                "mel_group": s.mel_group, "mel_bucket": s.MEL_BUCKET,
                "frames_per_phone": s.acfg.frames_per_phone}

    def _plan(self, i: int, mel_lens: List[int]) -> List[Dict]:
        from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import \
            PHONE_BUCKETS
        return check_tts.plan([len(x) for x in self.ids[i]], mel_lens,
                              PHONE_BUCKETS, self._knobs())

    def end_to_end(self) -> Dict[str, float]:
        return {"audio_throughput": self.audio_s / self.window_s}

    def context(self) -> Dict:
        """The window's record: each job's probe and synthesis calls
        (rebuilt from what it served: rows' phones and mel lengths), and
        the programs' replays the profile saw."""
        return {"window_s": self.window_s, "calls": self.calls,
                "captures_window": self.captures_window}

    # ------------------------------------------------------------- check
    def free(self) -> None:
        self.knobs = self._knobs()
        self.jobs.close()
        del self.jobs, self.synth

    def _reference_segments(self, ap, vp, i: int, mel_lens: List[int]
                            ) -> List[Dict]:
        """The reference's segments of text i at the phone buckets and mel
        lengths of the calls the service made for it."""
        from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import \
            PHONE_BUCKETS
        a, v = self.config["sambert"], self.config["hifigan"]
        spk = 0     # every voice of the traffic is the synthesizer's first
        out: List[Optional[Dict]] = [None] * len(self.ids[i])
        for c in check_tts.plan([len(x) for x in self.ids[i]], mel_lens,
                                PHONE_BUCKETS, self.knobs):
            if c["kind"] != "synth":
                continue
            for j in c["segments"]:
                ids = torch.as_tensor(self.ids[i][j], device=self.device)
                with torch.inference_mode():
                    seg = ref.segment(ap, a, vp, v, ids, spk, c["l"],
                                      c["t_mel"])
                out[j] = dict(seg, before_rounding=seg["before_rounding"]
                              .cpu().numpy())
        return out

    def _judge(self, picks: List[int], ap, vp, served: Dict[int, Dict]
               ) -> Dict[str, float]:
        svc = self.config["service"]
        margin = self.traffic["check"]["fragile"]
        total = {"dur_changed": 0, "pcm_gap_lsb": 0.0,
                 "pcm_gap_lsb_same_lengths": 0.0, "fragile_segments": 0,
                 "segments": 0, "jobs": len(picks)}
        for i in picks:
            s = served[i]
            segs = self._reference_segments(ap, vp, i, s["mel_lens"])
            got = check_tts.judge_job(
                s["pcm"], s["mel_lens"], segs, self.pauses[i], self.hop,
                self.sr, svc["crossfade_ms"], margin,
                self.config["sambert"]["max_duration"], ref.assemble,
                ref.to_pcm16)
            total["dur_changed"] += got["dur_changed"]
            for k in ("pcm_gap_lsb", "pcm_gap_lsb_same_lengths"):
                total[k] = max(total[k], got[k])
            total["fragile_segments"] += got["fragile_segments"]
            total["segments"] += len(segs)
        return total

    def _pick(self, done: List[int]) -> List[int]:
        rng = np.random.default_rng(self.seed + 1)
        n = min(self.traffic["check"]["jobs"], len(done))
        return sorted(int(x) for x in rng.choice(sorted(done), size=n,
                                                 replace=False))

    def check(self) -> Dict[str, float]:
        """`check.jobs` texts of the window drawn from the seed, each as
        last served, against the reference on weights drawn again; with
        the window's speech rate, frames per phone and decoder steps per
        job as diagnostics."""
        ap, vp = make_params(self.config, self.seed, self.device,
                             self.calibration, self.p["layout_seed"])
        out = self._judge(self._pick(list(self.served)), ap, vp, self.served)
        return dict(out, **self._rates())

    def _rates(self) -> Dict[str, float]:
        from toolbox_for_asr_and_tts_tpu_torch.tts.pinyin_data import \
            PINYIN_TABLE
        frames = phones = syllables = 0
        for i in self.done:
            frames += sum(self.served[i]["mel_lens"])
            phones += sum(len(x) for x in self.ids[i])
            syllables += sum(ch in PINYIN_TABLE for ch in self.texts[i])
        r = self.config["sambert"]["outputs_per_step"]
        steps = sum(-(-c["t_mel"] // r) for c in self.calls
                    if c["kind"] == "synth")
        if not frames:
            return {}
        return {"syllables_per_s": syllables * self.sr / (frames * self.hop),
                "frames_per_phone": frames / phones,
                "ar_steps_per_job": steps / len(self.done),
                "jobs_done": len(self.done)}

    def control(self, mode: str) -> Dict[str, float]:
        """The reference in the program's place with TF32 on (mode
        "tf32"), on the texts a run's check would pick, judged as the
        program's WAVs are."""
        from portbench.precision import tf32
        svc = self.config["service"]
        ap, vp = make_params(self.config, self.seed, self.device,
                             self.calibration, self.p["layout_seed"])
        from toolbox_for_asr_and_tts_tpu_torch.runtime.autotune import \
            env_or_profile
        from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import \
            Synthesizer
        self.knobs = {
            "batch_size": svc["batch_size"],
            "group_by_length": env_or_profile("TTS_GROUP_BY_LENGTH",
                                              "tts_group_by_length"),
            "mel_group": env_or_profile("TTS_MEL_GROUP", "tts_mel_group"),
            "mel_bucket": Synthesizer.MEL_BUCKET,
            "frames_per_phone": self.config["sambert"]["frames_per_phone"]}
        picks = self._pick(list(range(len(self.texts))))
        served = {}
        for i in picks:
            with tf32(mode == "tf32"):
                served[i] = self._as_served(ap, vp, i)
        return self._judge(picks, ap, vp, served)

    def _as_served(self, ap, vp, i: int) -> Dict:
        """Text i synthesized by the reference as the service would serve
        it: the mel lengths its own durations give, the calls they make,
        its segments at those calls' shapes, assembled into the WAV."""
        from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import \
            PHONE_BUCKETS
        a, v = self.config["sambert"], self.config["hifigan"]
        lens = []
        for ids in self.ids[i]:
            l = next(b for b in PHONE_BUCKETS if b >= len(ids))
            with torch.inference_mode():
                x, log_dur = ref.encode(ap, a, torch.as_tensor(
                    ids, device=self.device), 0, l)
            lens.append(int(ref.durations(log_dur, a)[0].sum()))
        plan = check_tts.plan([len(x) for x in self.ids[i]], lens,
                              PHONE_BUCKETS, self.knobs)
        capped = list(lens)
        for c in plan:
            if c["kind"] == "synth":
                r = a["outputs_per_step"]
                for j in c["segments"]:
                    capped[j] = min(lens[j], -(-c["t_mel"] // r) * r)
        segs = self._reference_segments(ap, vp, i, capped)
        svc = self.config["service"]
        wav = ref.assemble([s["pcm"].astype(np.float32) / 32767.0
                            for s in segs], self.pauses[i], self.sr,
                           svc["crossfade_ms"])
        return {"pcm": ref.to_pcm16(wav), "mel_lens": capped}
