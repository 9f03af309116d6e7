"""Streaming recognition through the service's chunked hub: an open loop
of sessions that each send 0.4 s frames on a real-time schedule.

The hub is the one `service/engines.py::_streaming_factory` gives the voice
service (one `ChunkedHub`: fused, bucketed, pipelined, at the card's
dispatch profile's capacity), and each session is the service's
`HubStreamingRecognizer`: `push_audio` per frame, `finalize` at the end of
an utterance, then the next utterance on the same row.

Traffic parameters ("params"):
- sessions: concurrent sessions S;
- frame_s: seconds of audio per frame (the voice service's 0.4 s);
- utterance_s: [low, high]: utterance lengths, uniform;
- utterances_per_session: how many lengths each session cycles through;
- warm_frames: frames each session sends, then finalizes, in set-up;
- layout_seed: the fixed draw that lays the sessions' schedule out.

Every seed serves the same work at the same times: each session's
utterance lengths are the same quantiles of the uniform law, and the start
offsets are quantiles over one frame period, laid out once by the traffic's
`layout_seed` (which session starts when, and the order of its lengths).
The run's seed draws the audio, the weights, the CMVN and the sample that
the check compares. (A layout drawn from the run's seed moved the tail
of the finals with it: which finalizes coincide follows the layout.)

Each frame is timed from when it was due, not from when it was sent: a
session still waiting for its last partial sends late, and that wait
counts. The generator's lateness (sent − due) is recorded. No frame is sent
after the window closes; the frames and finalizes in flight then are waited
for and counted with their latency.
"""
from __future__ import annotations

import contextlib
import os
import re
import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from portbench import weights  # noqa: E402
from portbench.weights import ids_of, tokenizer  # noqa: E402
from portbench.reference import paraformer as ref  # noqa: E402

SR = 16000


def percentile(xs: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation (numpy's default)."""
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else float("nan")


def schedule(p: Dict):
    """(start offsets [S], utterance lengths in samples [S][U])."""
    s, u = p["sessions"], p["utterances_per_session"]
    lo, hi = p["utterance_s"]
    rng = np.random.default_rng(p["layout_seed"])
    offsets = [p["frame_s"] * (i + 0.5) / s for i in rng.permutation(s)]
    quant = [lo + (hi - lo) * (j + 0.5) / u for j in range(u)]
    lens = [[int(round(quant[j] * SR)) for j in rng.permutation(u)]
            for _ in range(s)]
    return offsets, lens


def hub_stats() -> Dict[str, float]:
    """The chunked hub's tick count and wall sum from the service's metric
    registry (what its `/metrics` serves)."""
    from toolbox_for_asr_and_tts_tpu_torch.runtime import prom
    text = prom.REGISTRY.render()
    out = {}
    for key, pat in (("sum", r'toolbox_hub_tick_seconds_sum\{hub="chunked"\} (\S+)'),
                     ("count", r'toolbox_hub_tick_seconds_count\{hub="chunked"\} (\S+)')):
        m = re.search(pat, text)
        out[key] = float(m.group(1)) if m else 0.0
    return out


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.m = config["model"]
        self.o = config["online"]
        self.fe = config["frontend"]
        self.p = traffic["params"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.attempted = self.failed = 0
        self._lock = threading.Lock()
        self._open = threading.Event()      # sessions may call the program
        self._open.set()
        self._inside = 0                    # calls into the program now

    # ------------------------------------------------------------ set-up
    def setup(self, seconds: float) -> None:
        from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
        from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import \
            ParaformerConfig
        from toolbox_for_asr_and_tts_tpu_torch.service.engines import \
            _streaming_factory
        t = time.perf_counter()
        self.offsets, self.lens = schedule(self.p)
        params = weights.make_params(self.m, self.seed, self.device)
        cmvn = weights.make_cmvn(self.m["input_dim"], self.seed, self.device)
        reco = Recognizer(params, ParaformerConfig(**self.m),
                          tokenizer(self.m["vocab_size"]),
                          cmvn=tuple(c.cpu().numpy() for c in cmvn),
                          device=self.device, use_mesh=False)
        self.phases = {"weights, recognizer": time.perf_counter() - t}
        t = time.perf_counter()
        self.factory = _streaming_factory(reco, device=self.device)
        self.hub = self.factory.hub
        self.phases["hub and its captures"] = time.perf_counter() - t
        t = time.perf_counter()
        self.sessions = [self.factory() for _ in range(self.p["sessions"])]
        self.frame = int(round(self.p["frame_s"] * SR))
        warm = weights.make_audio([self.frame * self.p["warm_frames"]]
                                  * len(self.sessions), self.seed,
                                  self.device, stream=weights.BATCHES)
        self._run_threads(lambda s: self._warm(s, warm[s]))
        self.phases["sessions' first frames"] = time.perf_counter() - t
        t = time.perf_counter()
        self._audio(seconds)
        self.phases["audio"] = time.perf_counter() - t

    def _warm(self, s: int, wav: np.ndarray) -> None:
        rec = self.sessions[s]
        for i in range(0, len(wav), self.frame):
            rec.push_audio(wav[i: i + self.frame])
        rec.finalize()

    def _run_threads(self, fn, main=None) -> None:
        """fn(s) on one thread per session; `main()` meanwhile on this one.
        The first error of any session re-raises here."""
        errors: List[BaseException] = []

        def body(s):
            try:
                fn(s)
            except BaseException as e:   # re-raised in the main thread
                errors.append(e)
        threads = [threading.Thread(target=body, args=(s,), daemon=True)
                   for s in range(len(self.sessions))]
        for t in threads:
            t.start()
        if main is not None:
            main()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a session thread did not end")
        if errors:
            raise errors[0]

    def _audio(self, seconds: float) -> None:
        """Each session's utterances up to the window's end (and one more
        frame period), drawn on the device in one batch."""
        need, plan = [], []
        for s, lens in enumerate(self.lens):
            t, k = self.offsets[s], 0
            while t < seconds + self.p["frame_s"] and k < len(lens):
                need.append(lens[k])
                t += self.p["frame_s"] * -(-lens[k] // self.frame)
                k += 1
            plan.append(k)
        wavs = weights.make_audio(need, self.seed, self.device)
        self.wavs, i = [], 0
        for k in plan:
            self.wavs.append(wavs[i: i + k])
            i += k

    # ------------------------------------------------------------ window
    def window(self, seconds: float, tracer) -> None:
        self.partial_s: List[float] = []
        self.final_s: List[float] = []
        self.calls: List[Dict] = []         # the window's record
        # (session, utterance, final ids, each frame's partial text)
        self.finished: List[tuple] = []
        self.no_tick = 0        # partials returned with no hub tick since
        c0 = self._counters()
        self.counters = None
        self.traced_replays: Dict[int, int] = {}
        self.cut = None
        t0 = time.perf_counter() + 0.05
        self.t0, self.end = t0, t0 + seconds
        self._run_threads(self._session, lambda: self._trace(tracer))
        # with a profile, the hub's counters up to its start
        c1 = self.counters or self._counters()
        self.hub_window = {"ticks": c1[0] - c0[0],
                           "submissions": c1[1] - c0[1],
                           "tick_s": c1[2]["sum"] - c0[2]["sum"],
                           "tick_count": c1[2]["count"] - c0[2]["count"]}
        self.captures_window = c1[3] - c0[3]
        w = self.o["c0"] + self.o["c1"] + self.o["c2"]
        self.calls += [{"kind": "tick", "traced": True, "rows": b,
                        "frames": w, "count": n}
                       for b, n in sorted(self.traced_replays.items()) if n]

    def _trace(self, tracer) -> None:
        """Profile [after_s, after_s + seconds) of the window from this
        (the main) thread. The profiler starts and stops only while no
        session is inside the program (`_quiet`): a start while the hub's
        thread replays hung the process. The hub's counters and the
        generator's lateness are read before the first stop of the load;
        the tick programs' replays inside the profile give the K1 work."""
        tr = self.p["trace"]
        if not tracer.enabled:
            return
        at = min(tr["after_s"], 0.25 * (self.end - self.t0))
        time.sleep(max(0.0, self.t0 + at - time.perf_counter()))
        with self._quiet():
            self.cut = time.perf_counter() - self.t0
            self.counters = self._counters()
            tracer.begin(tr["seconds"])
            before = self._replays()
        time.sleep(max(0.0, min(tr["seconds"],
                                self.end - time.perf_counter())))
        with self._quiet():
            tracer.stop()
            after = self._replays()
        self.traced_replays = {b: after[b] - before.get(b, 0) for b in after}

    @contextlib.contextmanager
    def _quiet(self):
        """Hold new calls into the program back, and wait until none is in
        flight (the hub's tick thread then has nothing to run)."""
        self._open.clear()
        try:
            while True:
                with self._lock:
                    if self._inside == 0:
                        break
                time.sleep(0.001)
            yield
        finally:
            self._open.set()

    def _counters(self):
        from toolbox_for_asr_and_tts_tpu_torch.runtime import graphs
        return (self.hub.ticks, self.hub.submissions, hub_stats(),
                sum(o["captures"] for o in graphs.report()))

    def counters(self) -> Dict[str, int]:
        """The ticker's cover and drain counters (always on in the
        program), for the readers of a traced run."""
        t = self.hub.ticker
        return {"rows_stepped": t.rows_stepped, "rows_active": t.rows_active,
                "drains": t.drains, "drain_steps": t.drain_steps}

    def _replays(self) -> Dict[int, int]:
        progs = self.hub.ticker.programs
        out = {}
        for key in progs:
            if isinstance(key, tuple) and key[0] == "tick":
                out[key[1]] = progs.get(key, None).replays
        return out

    def _session(self, s: int) -> None:
        rec = self.sessions[s]
        due = self.t0 + self.offsets[s]
        fs = self.p["frame_s"]
        for u, wav in enumerate(self.wavs[s]):
            partials: List[str] = []
            last_due = due
            for i in range(0, len(wav), self.frame):
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                self._enter()
                sent = time.perf_counter()
                if sent >= self.end:
                    with self._lock:
                        self._inside -= 1
                        self.calls.append({"kind": "cut", "tokens": len(
                            partials[-1]) if partials else 0})
                    return
                ticks = self.hub.ticks
                try:
                    text = rec.push_audio(wav[i: i + self.frame])
                except Exception:
                    with self._lock:
                        self.attempted += 1
                        self.failed += 1
                    raise
                back = time.perf_counter()
                ticked = self.hub.ticks > ticks
                with self._lock:
                    self._inside -= 1
                    self.attempted += 1
                    self.no_tick += not ticked
                    self.partial_s.append(back - due)
                    self.calls.append({
                        "kind": "frame", "due_s": due - self.t0,
                        "late_s": sent - due,
                        "samples": min(self.frame, len(wav) - i)})
                partials.append(text)
                last_due = due
                due += fs
            self._enter()
            text = rec.finalize()
            back = time.perf_counter()
            with self._lock:
                self._inside -= 1
                self.final_s.append(back - last_due)
                self.finished.append((s, u, ids_of(text), partials))
                self.calls.append({"kind": "finalize",
                                   "tokens": len(ids_of(text))})

    def _enter(self) -> None:
        """Wait while the load is held back, then count a call in."""
        while True:
            self._open.wait()
            with self._lock:
                if self._open.is_set():
                    self._inside += 1
                    return

    def end_to_end(self) -> Dict[str, float]:
        return {"partial_p95_ms": 1e3 * percentile(self.partial_s, 95),
                "final_p95_ms": 1e3 * percentile(self.final_s, 95)}

    def context(self) -> Dict:
        """The window's record (each frame with its lateness, each final,
        the tick programs' replays the trace saw, by rows) and the hub's
        counters over the window."""
        return {"window_s": self.end - self.t0, "calls": self.calls,
                "hub": self.hub_window,
                "captures_window": self.captures_window,
                "trace_cut_s": self.cut}

    # ------------------------------------------------------------- check
    def free(self) -> None:
        for rec in self.sessions:
            rec.close()
        self.hub.close()
        del self.sessions, self.hub, self.factory

    def check(self) -> Dict[str, float]:
        """Every partial against its utterance's final, and against the
        hub's ticks (each push has to wait for a tick); a sample of the
        finished utterances drawn from the seed, the longest among them,
        against the reference streaming the same audio, on weights and CMVN
        drawn again from the seed: their finals token by token, and each
        frame's partial against the tokens the reference had fired by the
        chunks that the frames before it complete."""
        from portbench.check import (judge_online, judge_partials,
                                     partials_behind)
        fin = sorted(self.finished, key=lambda f: (f[0], f[1]))
        finals_text = ["".join(chr(0x4E00 + i) for i in f[2]) for f in fin]
        not_prefix = judge_partials([f[3] for f in fin], finals_text)
        rng = np.random.default_rng(self.seed + 1)
        n = min(self.traffic["check"]["utterances"], len(fin))
        pick = set(int(x) for x in rng.choice(len(fin), size=n, replace=False))
        pick.add(max(range(len(fin)),
                     key=lambda j: len(self.wavs[fin[j][0]][fin[j][1]])))
        pick = sorted(pick)
        params = weights.make_params(self.m, self.seed, self.device)
        cmvn = weights.make_cmvn(self.m["input_dim"], self.seed, self.device)
        cfg = dict(self.m, frontend=self.fe)
        sess = ref.OnlineSession(params, cfg, self.o, cmvn, self.device)
        utts = sess.run([self.wavs[fin[j][0]][fin[j][1]] for j in pick])
        fragile = self.traffic["check"]["fragile_mass"]
        out = judge_online(utts, [fin[j][2] for j in pick],
                           self.m["predictor_tail_threshold"], fragile)
        chunk = self.o["c1"] * self.fe["lfr_n"] * self.fe["frame_shift"]
        out["partial_behind"] = partials_behind(
            utts, [[ids_of(p) for p in fin[j][3]] for j in pick],
            self.frame, chunk, fragile)
        out["partial_not_prefix"] = not_prefix
        out["partial_without_tick"] = self.no_tick
        out["finals"] = len(fin)
        return out

    def control(self, mode: str) -> Dict[str, float]:
        """The reference with TF32 on (mode "tf32") in the program's place,
        on as many utterances as a run's check compares, the longest
        length among them, judged as the program's finals are."""
        from portbench.check import judge_online
        from portbench.precision import tf32
        self.offsets, self.lens = schedule(self.p)
        rng = np.random.default_rng(self.seed + 1)
        n = self.traffic["check"]["utterances"]
        flat = [(s, u) for s in range(len(self.lens))
                for u in range(len(self.lens[s]))]
        pick = [flat[int(i)] for i in rng.choice(len(flat), size=n,
                                                 replace=False)]
        pick.append(max(flat, key=lambda su: self.lens[su[0]][su[1]]))
        wavs = weights.make_audio([self.lens[s][u] for s, u in pick],
                                  self.seed, self.device)
        params = weights.make_params(self.m, self.seed, self.device)
        cmvn = weights.make_cmvn(self.m["input_dim"], self.seed, self.device)
        cfg = dict(self.m, frontend=self.fe)
        sess = ref.OnlineSession(params, cfg, self.o, cmvn, self.device)
        want = sess.run(wavs)
        with tf32(mode == "tf32"):
            low = sess.run(wavs)
        served = [[int(lg.argmax()) for lg, _ in u["tokens"]] for u in low]
        out = judge_online(want, served, self.m["predictor_tail_threshold"],
                           self.traffic["check"]["fragile_mass"])
        # the reference has no partials
        out.update(partial_behind=0, partial_not_prefix=0,
                   partial_without_tick=0)
        return out
