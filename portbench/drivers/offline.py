"""Offline recognition: a closed loop of `Recognizer.transcribe` on batches.

Traffic parameters (`portbench/traffic/<name>.json`, "params"):
- batch: utterances per call;
- lengths: {"median_s", "sigma", "min_s", "max_s"}: a log-normal of
  utterance lengths, clipped;
- batches: how many distinct batches the loop cycles through;
- layout_seed: the fixed draw that groups the lengths into batches.

Every seed serves the same multiset of batches: the lengths are the
distribution's quantiles, grouped into batches by `layout_seed`, so each
seed has the same padded shapes and the same work. The run's seed orders
the batches and draws the audio, the weights and the CMVN.

End-to-end: `audio_throughput`, seconds of valid audio transcribed over the
window's wall time (the window ends when the last call started before the
deadline returns). Each batch is served about twenty times a window: every
serve is held to the batch's first, and the reference judges the last.
"""
from __future__ import annotations

import os
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from portbench import weights  # noqa: E402
from portbench.weights import tokenizer  # noqa: E402
from portbench.reference import paraformer as ref  # noqa: E402

SR = 16000


def layout(p: Dict) -> List[List[int]]:
    """The batches' utterance lengths (samples), the same for every seed."""
    lg = p["lengths"]
    n = p["batch"] * p["batches"]
    nd = statistics.NormalDist()
    secs = [min(max(lg["median_s"] * float(np.exp(
        lg["sigma"] * nd.inv_cdf((i + 0.5) / n))), lg["min_s"]), lg["max_s"])
        for i in range(n)]
    order = np.random.default_rng(p["layout_seed"]).permutation(n)
    lens = [int(round(secs[i] * SR)) for i in order]
    return [lens[i: i + p["batch"]] for i in range(0, n, p["batch"])]


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.m = config["model"]
        self.fe = config["frontend"]
        self.p = traffic["params"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.attempted = self.failed = 0

    # ------------------------------------------------------------ set-up
    def setup(self, seconds: float) -> None:
        from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
        from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import \
            ParaformerConfig
        t = time.perf_counter()
        self.batches = layout(self.p)
        order = np.random.default_rng(self.seed).permutation(len(self.batches))
        self.order = [int(i) for i in order]
        flat = [n for b in self.batches for n in b]
        audio = weights.make_audio(flat, self.seed, self.device)
        self.audio, k = [], 0
        for b in self.batches:
            self.audio.append(audio[k: k + len(b)])
            k += len(b)
        params = weights.make_params(self.m, self.seed, self.device)
        cmvn = weights.make_cmvn(self.m["input_dim"], self.seed, self.device)
        self.reco = Recognizer(params, ParaformerConfig(**self.m),
                               tokenizer(self.m["vocab_size"]),
                               cmvn=tuple(c.cpu().numpy() for c in cmvn),
                               device=self.device)
        self.phases = {"audio, weights, recognizer": time.perf_counter() - t}
        t = time.perf_counter()
        # one call per bucket the batches reach captures its program; a
        # second replays it (pinned staging, first replay)
        first = {}
        for i, b in enumerate(self.batches):
            first.setdefault(self.reco.bucketer.bucket(max(b)), i)
        for i in first.values():
            for _ in range(2):
                self.reco.transcribe(self.audio[i])
        self.phases["captures"] = time.perf_counter() - t
        self._captures0 = self._captures()

    def _captures(self) -> int:
        from toolbox_for_asr_and_tts_tpu_torch.runtime import graphs
        return sum(o["captures"] for o in graphs.report())

    # ------------------------------------------------------------ window
    def window(self, seconds: float, tracer) -> None:
        p = self.p
        self.first: Dict[int, List[List[int]]] = {}   # each batch's first serve
        self.last: Dict[int, List[List[int]]] = {}    # and its latest
        self.changed = 0        # rows served otherwise than the first time
        self.calls: List[Dict] = []
        audio_s = 0.0
        t0 = time.perf_counter()
        end = t0 + seconds
        trace_at = t0 + min(p["trace"]["after_s"], 0.25 * seconds)
        k = 0
        while time.perf_counter() < end:
            if time.perf_counter() >= trace_at:
                tracer.begin(p["trace"]["seconds"])
            tracer.poll()
            traced_now = tracer.recording
            i = self.order[k % len(self.order)]
            k += 1
            with tracer.span("transcribe"):
                res = self.reco.transcribe(self.audio[i])
            self.attempted += len(res)
            ids = [list(r.token_ids) for r in res]
            first = self.first.setdefault(i, ids)
            self.changed += sum(a != b for a, b in zip(ids, first)) + \
                abs(len(ids) - len(first))
            self.last[i] = ids
            t, kmax = self._bucket_frames(i)
            self.calls.append({
                "kind": "transcribe", "batch_index": i, "traced": traced_now,
                "samples": list(self.batches[i]),
                "tokens": [len(x) for x in ids],
                "bucket_samples": self.reco.bucketer.bucket(max(self.batches[i])),
                "frames": t, "k_max": kmax})
            audio_s += sum(len(a) for a in self.audio[i]) / SR
        tracer.stop()
        self.window_s = time.perf_counter() - t0 - tracer.overhead_s
        self.audio_s = audio_s
        self.captures_window = self._captures() - self._captures0

    def end_to_end(self) -> Dict[str, float]:
        return {"audio_throughput": self.audio_s / self.window_s}

    def context(self) -> Dict:
        """The window's record for the per-layer metrics: each call with
        its rows' lengths and tokens, its bucket's shapes, and whether the
        trace saw it."""
        return {"window_s": self.window_s, "calls": self.calls,
                "captures_window": self.captures_window}

    def _bucket_frames(self, i: int):
        """(LFR frames, token cap) of batch i's bucket, as the reference
        works them out."""
        n = ref.bucket_samples(max(self.batches[i]), SR)
        t = -(-ref.n_fbank_frames(n, self.fe) // self.fe["lfr_n"])
        return t, ref.max_tokens(t)

    # ------------------------------------------------------------- check
    def free(self) -> None:
        del self.reco

    def check(self) -> Dict[str, float]:
        """Every serve of a batch against its first (`serve_changed`: rows
        that differ), and a sample of the window's batches drawn from the
        seed, the one with the longest utterance among them, as last
        served, against the reference run on weights and CMVN drawn again
        from the seed."""
        done = sorted(self.last)
        rng = np.random.default_rng(self.seed + 1)
        n = min(self.traffic["check"]["batches"], len(done))
        pick = set(int(x) for x in rng.choice(done, size=n, replace=False))
        pick.add(max(done, key=lambda i: max(self.batches[i])))
        params = weights.make_params(self.m, self.seed, self.device)
        cmvn = weights.make_cmvn(self.m["input_dim"], self.seed, self.device)
        cfg = dict(self.m, frontend=self.fe)
        rows, served, caps = [], [], []
        for i in sorted(pick):
            rows += ref.offline_logits(params, cfg, cmvn, self.audio[i],
                                       self.device)
            served += self.last[i]
            caps += [self._bucket_frames(i)[1]] * len(self.batches[i])
        from portbench.check import judge_offline
        out = judge_offline(rows, served, caps,
                            self.traffic["check"]["fragile_mass"])
        out["serve_changed"] = self.changed
        return out

    def control(self, mode: str) -> Dict[str, float]:
        """The reference in the program's place with TF32 on (mode "tf32"),
        on the batches a run's check would sample, judged as the program's
        answers are."""
        from portbench.check import judge_offline
        from portbench.precision import tf32
        rng = np.random.default_rng(self.seed + 1)
        self.batches = layout(self.p)
        n = self.traffic["check"]["batches"]
        pick = set(int(x) for x in rng.choice(len(self.batches), size=n,
                                              replace=False))
        pick.add(max(range(len(self.batches)),
                     key=lambda i: max(self.batches[i])))
        params = weights.make_params(self.m, self.seed, self.device)
        cmvn = weights.make_cmvn(self.m["input_dim"], self.seed, self.device)
        cfg = dict(self.m, frontend=self.fe)
        flat = [n for b in self.batches for n in b]
        audio = weights.make_audio(flat, self.seed, self.device)
        rows, served, caps = [], [], []
        for i in sorted(pick):
            wavs = audio[i * self.p["batch"]: (i + 1) * self.p["batch"]]
            rows += ref.offline_logits(params, cfg, cmvn, wavs, self.device)
            with tf32(mode == "tf32"):
                low = ref.offline_logits(params, cfg, cmvn, wavs, self.device)
            served += [lg.argmax(1).tolist() for lg, _, _ in low]
            caps += [self._bucket_frames(i)[1]] * len(wavs)
        out = judge_offline(rows, served, caps,
                            self.traffic["check"]["fragile_mass"])
        out["serve_changed"] = 0    # the reference serves each batch once
        return out
