"""Shared batched serving hubs: many WebSocket sessions, one device call.

Port of `toolbox_for_asr_and_tts_tpu/service/hub.py` over the port's
tickers (`parallel/stream_batcher.py`) and models, on their device (the
card unless the models were built for the CPU):

- `VadHub` / `HubVadStepper`: every session's chunk joins one
  `BatchedVadTicker.tick` per serving tick;
- `ChunkedHub` / `HubStreamingRecognizer`: every partial-enabled session's
  speech chunk joins one `BatchedChunkedASR.tick` (fused step, partials);
- `LanedHub`: N independent hub lanes behind one hub-shaped facade;
- `KwsHub`: concurrent wake-word windows meet in one
  `KeywordSpotter.detect_audio_batch`;
- `FinalizeHub`: concurrent end-of-utterance buffers meet in one
  `Diarizer.diarize_batch`.

Sessions submit from serving threads and block until the tick that
includes them resolves. Against the reference:
- no hub turns a model error into a default answer: a failed tick or batch
  raises its exception in every caller it held (the reference does this in
  KwsHub and FinalizeHub, and answers False / no new ids in VadHub and
  ChunkedHub);
- ChunkedHub serves with the reference's double-buffered dispatch by
  default (CHUNKED_PIPELINE=1, parsed once here): a tick's ids arrive at
  the next dispatch, or at leave / reset / finalize;
- the tickers' programs are built (on the card: captured) in the hub's
  constructor, before its tick thread starts (VOICE_AOT_TICKS=1, the
  default); lanes of a `LanedHub` share an `exec_cache`, where a graph
  that binds a lane's own state stays that lane's;
- `LanedHub.join` holds its lane lock across the pick, the join and the
  count, so concurrent joins spread over the lanes by their true load.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from ..runtime import profiling, prom

logger = logging.getLogger("toolbox.hub")

_HUB_TICKS = prom.counter("toolbox_hub_ticks_total",
                          "fused device ticks per serving hub", ("hub",))
_HUB_SUBS = prom.counter("toolbox_hub_submissions_total",
                         "session submissions batched by the hubs", ("hub",))
_HUB_BATCH = prom.histogram("toolbox_hub_batch_size",
                            "sessions per fused tick", ("hub",),
                            buckets=prom.SIZE_BUCKETS)
_HUB_LAT = prom.histogram("toolbox_hub_tick_seconds",
                          "fused tick wall time", ("hub",))


def _hub_timeout() -> float:
    """Submit-wait budget (VOICE_HUB_TIMEOUT_S, default 180 s): it bounds
    error reporting, not throughput."""
    try:
        return float(os.getenv("VOICE_HUB_TIMEOUT_S", "180"))
    except ValueError:
        return 180.0


def _wait(ev: threading.Event, holder: dict, what: str):
    """Block until a tick resolved this caller; its exception re-raises."""
    if not ev.wait(_hub_timeout()):
        raise TimeoutError(f"{what} timed out")
    if "exc" in holder:
        raise holder["exc"]
    return holder.get("res")


def _observe(hub: str, n: int, dt: float) -> None:
    _HUB_TICKS.inc(hub=hub)
    _HUB_SUBS.inc(n, hub=hub)
    _HUB_BATCH.observe(n, hub=hub)
    _HUB_LAT.observe(dt, hub=hub)
    if dt > 2.0:
        logger.warning("slow %s tick: %.1fs (batch %d)", hub, dt, n)


class _TickLoop:
    """The parked tick thread the row hubs share: it wakes on a submit,
    waits `tick_ms` for more, swaps the pending map out and ticks it."""

    def _start(self, name: str) -> None:
        self._stop = threading.Event()
        self._work = threading.Event()   # set on submit; idle loop parks
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            # park until a submit arrives; the timeout only re-checks _stop
            if not self._work.wait(timeout=0.25):
                continue
            self._work.clear()
            with profiling.annotate("hub.gather"):
                time.sleep(self.tick_ms / 1000.0)   # batch-gather window
            with self._lock:
                batch = self._pending
                self._pending = {}
            if batch:
                self._tick(batch)

    def close(self) -> None:
        self._stop.set()
        self._work.set()   # wake the parked loop so it can exit
        self._thread.join(timeout=10.0)


def _aot_ticks() -> bool:
    return os.getenv("VOICE_AOT_TICKS", "1") in ("1", "true")


class VadHub(_TickLoop):
    def __init__(self, params, cfg=None, capacity: int = 16,
                 threshold: float = 0.5, tick_ms: float = 10.0, cmvn=None,
                 exec_cache: Optional[dict] = None,
                 device: DeviceLike = None):
        from ..parallel.stream_batcher import BatchedVadTicker
        self.ticker = BatchedVadTicker(params, cfg, capacity, threshold,
                                       cmvn=cmvn, exec_cache=exec_cache,
                                       device=device)
        if _aot_ticks():
            # every fbank and step program of 0.4 s chunks at every pow-2
            # occupancy, before the tick thread starts
            self.ticker.warm()
        self.device = self.ticker.device
        self.tick_ms = tick_ms
        # slot → (chunk, [(event, holder), …], generation-at-queue)
        self._pending: Dict[int, Tuple[np.ndarray, list, int]] = {}
        self._lock = threading.Lock()
        self._ticker_lock = threading.Lock()  # tick vs join/leave/reset
        # per-slot generation: bumped on join/leave/reset so a chunk already
        # swapped into a tick batch is dropped, not fed to a reused slot
        self._gen: Dict[int, int] = {}
        self.ticks = 0            # telemetry: device ticks taken
        self.submissions = 0      # telemetry: chunks served
        self._start("vad-hub")

    # ------------------------------------------------------------- rows
    def join(self) -> int:
        with self._ticker_lock:
            slot = self.ticker.join()
        with self._lock:
            self._gen[slot] = self._gen.get(slot, 0) + 1
        return slot

    def _drop_pending(self, slot: int) -> None:
        """Invalidate the slot's queued chunk and release its waiters: the
        stream is discarded, so False is the honest answer."""
        with self._lock:
            self._gen[slot] = self._gen.get(slot, 0) + 1
            dropped = self._pending.pop(slot, None)
        if dropped is not None:
            for ev, holder in dropped[1]:
                holder["res"] = False
                ev.set()

    def leave(self, slot: int) -> None:
        self._drop_pending(slot)
        with self._ticker_lock:
            self.ticker.leave(slot)

    def reset(self, slot: int) -> None:
        self._drop_pending(slot)
        with self._ticker_lock:
            self.ticker.reset_slot(slot)

    # ------------------------------------------------------------ submit
    def submit(self, slot: int, chunk: np.ndarray,
               timeout: Optional[float] = None) -> bool:
        del timeout   # the budget is _hub_timeout()
        ev, holder = threading.Event(), {}
        chunk = np.asarray(chunk, np.float32)
        with self._lock:
            gen = self._gen.get(slot, 0)
            if slot in self._pending:
                # coalesce back-to-back submits: both waiters get this
                # tick's decision
                prev, waiters, _ = self._pending[slot]
                chunk = np.concatenate([prev, chunk])
                waiters = waiters + [(ev, holder)]
            else:
                waiters = [(ev, holder)]
            self._pending[slot] = (chunk, waiters, gen)
        self._work.set()
        return bool(_wait(ev, holder, "VAD hub tick"))

    def _tick(self, batch) -> None:
        t_tick = time.perf_counter()
        try:
            with self._ticker_lock:
                # drop entries whose slot was freed or reset after queueing
                with self._lock:
                    live = {s: v for s, v in batch.items()
                            if self._gen.get(s, 0) == v[2]}
                results = self.ticker.tick(
                    {s: c for s, (c, _, _) in live.items()})
            outcome = {s: {"res": results.get(s, False)} for s in batch}
        except Exception as e:
            logger.exception("VAD hub tick failed")
            outcome = {s: {"exc": e} for s in batch}
        self.ticks += 1
        self.submissions += len(batch)
        _observe("vad", len(batch), time.perf_counter() - t_tick)
        for s, (_, waiters, _) in batch.items():
            for ev, holder in waiters:
                holder.update(outcome[s])
                ev.set()


class ChunkedHub(_TickLoop):
    """Batched streaming partials: every partial-enabled session's speech
    chunk joins one `BatchedChunkedASR.tick` (fused step with partials) per
    serving tick. Decoded ids accumulate per slot; `submit` returns the
    session's partial text so far. Rows shard over an optional mesh's
    "data" axis (`BatchedChunkedASR(mesh=...)`).

    `finalize` takes the ticker lock once, for the ticker's `take_slot`
    (the in-flight step harvested, the slot's state row copied out, the
    slot reset), and drains the copy outside it (`drain`: the row's own
    steps and the CIF tail fire), so ticks go on while a drain runs.

    Spans (`runtime/profiling.py`): `hub.queue` per submission, from the
    submit until the tick that carries it holds the ticker lock (its
    `cause` is that `hub.tick`); `hub.gather`, the tick thread's gather
    sleep; `hub.tick`, the interval the tick histogram observes, over
    `hub.lock_wait`; `hub.finalize`, over `hub.finalize.lock_wait`,
    `hub.finalize.hold` (the take, under the ticker lock) and
    `hub.finalize.drain` (the steps and the tail, off it)."""

    def __init__(self, params, cfg, ocfg, tokenizer, cmvn=None,
                 capacity: int = 16, tick_ms: float = 10.0,
                 exec_cache: Optional[dict] = None,
                 device: DeviceLike = None, mesh=None):
        from ..parallel.stream_batcher import BatchedChunkedASR
        # serving default: double-buffered dispatch, the fetch of tick t−1
        # overlapping tick t; partials lag one tick, finalize returns every
        # id. CHUNKED_PIPELINE=0 fetches every tick.
        self.ticker = BatchedChunkedASR(
            params, cfg, ocfg, capacity=capacity, cmvn=cmvn, partials=True,
            pipelined=os.getenv("CHUNKED_PIPELINE", "1") in ("1", "true"),
            exec_cache=exec_cache, device=device, mesh=mesh)
        if _aot_ticks():
            # the step program of every pow-2 occupancy and the finalize
            # drain's step and tail, before the tick thread starts
            self.ticker.warm()
        self.device = self.ticker.device
        self.cfg = cfg   # model geometry, as the per-session recognizers
        self.tokenizer = tokenizer
        self.tick_ms = tick_ms
        self._ids: Dict[int, list] = {}
        # slot → (chunk, [(event, holder), …], generation-at-queue)
        self._pending: Dict[int, Tuple[np.ndarray, list, int]] = {}
        self._gen: Dict[int, int] = {}   # see VadHub._gen
        self._lock = threading.Lock()
        # serializes ticker state (tick vs join/leave/reset and the
        # finalize's take; its drain runs off it)
        self._ticker_lock = threading.Lock()
        self.ticks = 0
        self.submissions = 0
        self._start("chunked-hub")

    # ------------------------------------------------------------- rows
    def join(self) -> int:
        with self._ticker_lock:
            slot = self.ticker.join()
        with self._lock:
            self._gen[slot] = self._gen.get(slot, 0) + 1
            self._ids[slot] = []
        return slot

    def _release(self, slot: int, keep_ids: bool) -> None:
        """Invalidate the slot's queued chunk and release its waiters (they
        read the slot's text as it stands)."""
        with self._lock:
            self._gen[slot] = self._gen.get(slot, 0) + 1
            dropped = self._pending.pop(slot, None)
            if not keep_ids:
                self._ids.pop(slot, None)
        if dropped is not None:
            for ev, holder in dropped[1]:
                profiling.end(holder["queue"])
                ev.set()

    def leave(self, slot: int) -> None:
        self._release(slot, keep_ids=False)
        with self._ticker_lock:
            self.ticker.leave(slot)

    def reset(self, slot: int) -> None:
        self._release(slot, keep_ids=False)
        with self._lock:
            self._ids[slot] = []
        with self._ticker_lock:
            self.ticker.reset_slot(slot)

    # ------------------------------------------------------------ submit
    def submit(self, slot: int, chunk: np.ndarray,
               timeout: Optional[float] = None) -> str:
        """Queue this session's chunk for the next tick, block until the
        tick that includes it resolves, return the partial text so far.
        Its `hub.queue` span ends when that tick holds the ticker lock."""
        del timeout
        ev, holder = threading.Event(), {"queue": profiling.begin("hub.queue")}
        chunk = np.asarray(chunk, np.float32)
        with self._lock:
            gen = self._gen.get(slot, 0)
            if slot in self._pending:   # coalesce back-to-back submits
                prev, waiters, _ = self._pending[slot]
                chunk = np.concatenate([prev, chunk])
                waiters = waiters + [(ev, holder)]
            else:
                waiters = [(ev, holder)]
            self._pending[slot] = (chunk, waiters, gen)
        self._work.set()
        _wait(ev, holder, "chunked-ASR hub tick")
        return self.partial_text(slot)

    def partial_text(self, slot: int) -> str:
        with self._lock:
            return self.tokenizer.ids_to_text(self._ids.get(slot, []))

    def finalize(self, slot: int) -> str:
        """Drain the slot (remainder + lookahead + CIF tail fire), return
        the utterance's final text; the slot is reset at the take."""
        with profiling.annotate("hub.finalize"):
            self._release(slot, keep_ids=True)
            with profiling.annotate("hub.finalize.lock_wait"):
                self._ticker_lock.acquire()
            try:
                with profiling.annotate("hub.finalize.hold"):
                    taken = self.ticker.take_slot(slot)
            finally:
                self._ticker_lock.release()
            # the take harvested every row's carried ids
            self._extend(taken.fired)
            with profiling.annotate("hub.finalize.drain"):
                new = self.ticker.drain(taken)
            with self._lock:
                ids = self._ids.get(slot, []) + [int(i) for i in new]
                self._ids[slot] = []
            return self.tokenizer.ids_to_text(ids)

    def _extend(self, fired: Dict[int, list]) -> None:
        with self._lock:
            for s, ids in fired.items():
                if ids and s in self._ids:
                    self._ids[s].extend(int(i) for i in ids)

    def _tick(self, batch) -> None:
        # `hub.tick` spans the interval the tick histogram observes
        with profiling.annotate("hub.tick") as tick:
            t_tick = time.perf_counter()
            exc = None
            try:
                with profiling.annotate("hub.lock_wait"):
                    self._ticker_lock.acquire()
                try:
                    if tick is not None:
                        for _, waiters, _ in batch.values():
                            for _, holder in waiters:
                                profiling.end(holder["queue"], cause=tick)
                    with self._lock:
                        live = {s: v for s, v in batch.items()
                                if self._gen.get(s, 0) == v[2]}
                    fired = self.ticker.tick(
                        {s: c for s, (c, _, _) in live.items()})
                finally:
                    self._ticker_lock.release()
                self._extend(fired)
            except Exception as e:
                logger.exception("chunked hub tick failed")
                exc = e
            self.ticks += 1
            self.submissions += len(batch)
            _observe("chunked", len(batch), time.perf_counter() - t_tick)
        for _, waiters, _ in batch.values():
            for ev, holder in waiters:
                if exc is not None:
                    holder["exc"] = exc
                ev.set()


class HubStreamingRecognizer:
    """Per-session facade over ChunkedHub with the streaming recognizer's
    interface (`push_audio(chunk) -> partial text`, `reset()`)."""

    def __init__(self, hub):
        self.hub = hub
        self.cfg = hub.cfg
        self.slot: Optional[int] = hub.join()

    def push_audio(self, chunk: np.ndarray) -> str:
        if self.slot is None:
            raise RuntimeError("recognizer already closed")
        return self.hub.submit(self.slot, chunk)

    def partial_text(self) -> str:
        if self.slot is None:
            return ""
        return self.hub.partial_text(self.slot)

    def finalize(self) -> str:
        if self.slot is None:
            return ""
        return self.hub.finalize(self.slot)

    def reset(self) -> None:
        if self.slot is None:
            return
        self.hub.reset(self.slot)

    def close(self) -> None:
        if self.slot is not None:
            self.hub.leave(self.slot)
            self.slot = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class HubVadStepper:
    """Per-session facade over VadHub with the VAD stepper's interface
    (`stepper(chunk) -> bool`, `reset()`)."""

    def __init__(self, hub):
        self.hub = hub
        self.slot: Optional[int] = hub.join()

    def __call__(self, chunk: np.ndarray) -> bool:
        if self.slot is None:
            raise RuntimeError("stepper already closed")
        return self.hub.submit(self.slot, chunk)

    def reset(self) -> None:
        if self.slot is None:   # a closed stepper must not touch the hub
            return
        self.hub.reset(self.slot)

    def close(self) -> None:
        if self.slot is not None:
            self.hub.leave(self.slot)
            self.slot = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class LanedHub:
    """N independent hub lanes behind one hub-shaped facade, each with its
    own tick thread; slots encode their lane (`global = inner * n + lane`).
    A join goes to the least-occupied lane, falling through to the next
    while a lane is at capacity; the lane lock is held across the pick, the
    join and the count, so concurrent joins see each other's rows."""

    def __init__(self, make_lane, n_lanes: int):
        self.n = int(n_lanes)
        self.lanes = []
        try:
            for i in range(self.n):
                self.lanes.append(make_lane(i))
        except Exception:
            for lane in self.lanes:   # no tick thread outlives a failed build
                lane.close()
            raise
        self._live = [0] * self.n
        self._jlock = threading.Lock()

    # ------------------------------------------------------------- rows
    def join(self) -> int:
        from ..parallel.stream_batcher import AtCapacity
        with self._jlock:
            for i in sorted(range(self.n), key=lambda i: (self._live[i], i)):
                try:
                    inner = self.lanes[i].join()
                except AtCapacity:
                    continue
                self._live[i] += 1
                return inner * self.n + i
            raise AtCapacity(f"all {self.n} hub lanes at capacity "
                             f"({sum(self._live)} live rows)")

    def _route(self, slot: int):
        return self.lanes[slot % self.n], slot // self.n

    def leave(self, slot: int) -> None:
        lane, inner = self._route(slot)
        lane.leave(inner)
        with self._jlock:
            self._live[slot % self.n] -= 1

    def reset(self, slot: int) -> None:
        lane, inner = self._route(slot)
        lane.reset(inner)

    # ------------------------------------------------------------ submit
    def submit(self, slot: int, chunk: np.ndarray,
               timeout: Optional[float] = None):
        lane, inner = self._route(slot)
        return lane.submit(inner, chunk, timeout)

    def partial_text(self, slot: int) -> str:
        lane, inner = self._route(slot)
        return lane.partial_text(inner)

    def finalize(self, slot: int) -> str:
        lane, inner = self._route(slot)
        return lane.finalize(inner)

    def __getattr__(self, name):
        # cfg, tokenizer, tick_ms, device … are the same in every lane
        if name == "lanes":          # no recursion during __init__
            raise AttributeError(name)
        return getattr(self.lanes[0], name)

    # --------------------------------------------------------- telemetry
    @property
    def ticks(self) -> int:
        return sum(lane.ticks for lane in self.lanes)

    @property
    def submissions(self) -> int:
        return sum(lane.submissions for lane in self.lanes)

    def close(self) -> None:
        for lane in self.lanes:
            lane.close()


def tick_lanes() -> int:
    """VOICE_TICK_LANES: how many parallel tick lanes the serving hubs run
    (see LanedHub). 1 = one hub."""
    try:
        return max(1, int(os.getenv("VOICE_TICK_LANES", "1")))
    except ValueError:
        return 1


class _GatherHub:
    """A stateless gather hub: callers queue items; worker threads wait
    `window_ms` after a wake, take up to `max_batch` items, and resolve
    them with one batched call (`_run`). A failed call raises in each of
    its callers."""

    def _start(self, name: str, workers: Optional[int]) -> None:
        self._pending: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._work = threading.Event()
        self.batches = 0             # telemetry
        self.requests = 0
        self._threads = [threading.Thread(target=self._loop, daemon=True,
                                          name=f"{name}-{i}")
                         for i in range(workers if workers is not None
                                        else tick_lanes())]
        for t in self._threads:
            t.start()

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def _submit(self, item: tuple, what: str):
        ev, holder = threading.Event(), {}
        with self._lock:
            self._pending.append(item + (ev, holder))
        self._work.set()
        return _wait(ev, holder, what)

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self._work.wait(timeout=0.25):
                continue
            self._work.clear()
            time.sleep(self.window_ms / 1000.0)   # batch-gather window
            with self._lock:
                batch = self._pending[: self.max_batch]
                self._pending = self._pending[self.max_batch:]
                if self._pending:
                    self._work.set()   # overflow rolls into the next round
                if batch:
                    self.batches += 1
                    self.requests += len(batch)
            if not batch:
                continue
            t_tick = time.perf_counter()
            self._run(batch)
            _observe(self.hub_name, len(batch), time.perf_counter() - t_tick)

    @staticmethod
    def _resolve(items, results=None, exc=None) -> None:
        for i, item in enumerate(items):
            ev, holder = item[-2], item[-1]
            if exc is not None:
                holder["exc"] = exc
            else:
                holder["res"] = results[i]
            ev.set()

    def close(self) -> None:
        self._stop.set()
        self._work.set()
        for t in self._threads:
            t.join(timeout=10.0)


class KwsHub(_GatherHub):
    """Cross-session wake-word batching: every session waiting for its wake
    word scores its 1600 ms window once per 0.4 s chunk; the hub gathers
    concurrent `detect_audio` calls and runs one
    `KeywordSpotter.detect_audio_batch`. Drop-in for `VoiceEngines.kws`:
    everything else proxies the spotter."""

    hub_name = "kws"

    def __init__(self, spotter, window_ms: float = 20.0,
                 max_batch: Optional[int] = None,
                 workers: Optional[int] = None):
        self.inner = spotter
        self.window_ms = window_ms
        self.max_batch = (max_batch if max_batch is not None else
                          int(os.getenv("VOICE_KWS_MAX_BATCH", "64")))
        self._start("kws-hub", workers)

    def warm(self, max_batch: Optional[int] = None, **kw) -> None:
        self.inner.warm(max_batch=max_batch or self.max_batch, **kw)

    def detect_audio(self, window: np.ndarray) -> Tuple[bool, float]:
        return self._submit((np.asarray(window, np.float32),),
                            "KWS hub batch")

    def _run(self, batch) -> None:
        try:
            results = self.inner.detect_audio_batch([it[0] for it in batch])
        except Exception as e:
            logger.exception("KWS hub batch failed")
            self._resolve(batch, exc=e)
            return
        self._resolve(batch, results)


class FinalizeHub(_GatherHub):
    """Cross-session finalize batching: concurrent sessions' end-of-
    utterance buffers meet in one `Diarizer.diarize_batch` per (sample
    rate, need_spk) group — one bucketed recognition batch and one
    embedding call. Drop-in for `VoiceEngines.diarizer`: `diarize` blocks
    until its batch resolves; everything else proxies the diarizer."""

    hub_name = "finalize"

    def __init__(self, diarizer, window_ms: float = 30.0,
                 max_batch: Optional[int] = None,
                 workers: Optional[int] = None):
        self.inner = diarizer
        self.window_ms = window_ms
        self.max_batch = (max_batch if max_batch is not None else
                          int(os.getenv("VOICE_FINALIZE_MAX_BATCH", "64")))
        self._start("finalize-hub", workers)

    def diarize(self, wav, sample_rate: int = 16000,
                need_spk: bool = True):
        return self._submit((np.asarray(wav, np.float32), sample_rate,
                             bool(need_spk)), "finalize hub")

    def _run(self, batch) -> None:
        by_key: dict = {}
        for item in batch:
            by_key.setdefault((item[1], item[2]), []).append(item)
        for (sr, need_spk), items in by_key.items():
            try:
                wavs = [it[0] for it in items]
                if need_spk:
                    outs = self.inner.diarize_batch(wavs, sr)
                else:
                    outs = self.inner.diarize_batch(wavs, sr, need_spk=False)
            except Exception as e:
                logger.exception("finalize hub batch failed")
                self._resolve(items, exc=e)
                continue
            self._resolve(items, outs)
