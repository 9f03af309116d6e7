"""Batched multi-session streaming: many connections, one step per tick.

Port of `toolbox_for_asr_and_tts_tpu/parallel/stream_batcher.py`. In the
fused form (the default), session states are stacked tensors ([S, …] rows,
the stacked caches [layers, S, …]); without a mesh, live sessions occupy
the contiguous row prefix [0, n_live) — `leave` moves the last live row
into the vacated one — so a tick steps the pow-2 prefix that covers its
highest ready row and writes the result back into the state in place,
masked to the rows that had a chunk (`torch.where(..., out=)` into the
prefix view; the reference's donated `dynamic_update_slice`).

Each prefix bucket's step is one program (`runtime/graphs.py`; the
reference's AOT-compiled `_prefix_exec` / `_exec`): on the card a captured
CUDA graph that binds the bucket's prefix views of the state, whose
addresses never change. `warm()` builds every bucket.

`exec_cache` shares programs between tickers of one `LanedHub` as the
reference does, behind the same kind of signature (plus a CMVN and a
weights fingerprint). A reference executable takes the state as an
argument, so every lane reuses every program; a graph binds its own lane's
state buffers, so here each lane keeps its own tick programs and shares
only the programs that read no lane's state: the chunked finalize's drain
step and "tail" decode (over a one-row state of their own, the row copied
in) and the VAD fbank.

The chunked finalize drains its row in two halves. `take_slot`, under the
caller's ticker lock, harvests the in-flight step, copies the slot's state
row and audio remainder out and resets the slot; `drain`, outside that
lock, steps the copy alone (the b = 1 "drain" program, 2-3 replays) and
fires the CIF tail, on a stream of its own on the card, serialized with
other drains by the drain lock. Ticks go on meanwhile: the row has no
audio and is masked, and a `leave` that moves it cannot touch the copy.

PARAFORMER_TRANSFER_INT16 (else the dispatch profile's
`asr_int16_transfer`), read at construction as the reference reads it:
`BatchedChunkedASR`'s chunk upload and `BatchedVadTicker`'s fbank upload go
as int16 PCM (`asr/recognizer.py::to_int16_pcm`) into int16 staging rows,
and each program turns them back into f32 · 2^-15 before the fbank.

`mesh=` (a `runtime/mesh.py::Mesh` with a "data" axis) shards
`BatchedChunkedASR`'s rows by position over that axis, as the reference's
mesh path: each position holds capacity / n rows of state, a replica of the
weights per distinct device and its own step program; a slot keeps its row
(slot = row), and every tick steps every position's rows in full, masked,
since rows are placed by position (the reference's `:130-133`). A capacity
that does not divide over the axis raises.

`bucketed=False` runs the fused step as the mesh path does on one device:
slot = row, every step covers all `capacity` rows, masked.

`fused=False` is the reference's host-frontend ticker: each session keeps
its LFR frontend and a feature queue on the host; a tick computes the fbank
of every ready row in fixed quanta of `FBANK_QUANTA` frames (one program
per ready count, kernel K2, shared through `exec_cache`), drains LFR per
session, then runs full-capacity encoder + CIF steps (K1 in every layer)
over the rows holding c1 frames, slot = row. The unfused state is
`paraformer_online.init_state`'s; on a mesh it stays on the first
position, as the reference neither shards nor splits it.
"""
from __future__ import annotations

import hashlib
import logging
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..asr.recognizer import from_int16_pcm, to_int16_pcm
from ..models import fsmn_vad
from ..models import paraformer as pf
from ..models import paraformer_online as po
from ..models.convert import tree_to
from ..models.paraformer_streaming import StreamingFrontend
from ..ops import frontend as fe
from ..runtime import profiling
from ..runtime.autotune import env_or_profile
from ..runtime.graphs import Programs, to_host
from ..runtime.mesh import Mesh, per_position

logger = logging.getLogger("toolbox.stream_batcher")


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _fingerprint(arrays) -> Optional[str]:
    """A digest of CMVN vectors (None without CMVN)."""
    if arrays is None:
        return None
    h = hashlib.sha1()
    for a in arrays:
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        h.update(np.ascontiguousarray(np.asarray(a, np.float32)).tobytes())
    return h.hexdigest()


def _weights_id(params) -> str:
    """A digest of the weights' buffer addresses: a graph reads the weights
    where they lie, so only tickers over the same buffers share programs."""
    ptrs: List[int] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            ptrs.append(t.data_ptr())
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(params)
    return hashlib.sha1(np.asarray(ptrs, np.int64).tobytes()).hexdigest()


def _share(exec_cache: Optional[dict], sig: tuple, device, name: str,
           own_stream: bool = False) -> Programs:
    """The programs shared through `exec_cache` (a fresh owner without
    one); a cache already holding another signature raises."""
    if exec_cache is None:
        return Programs(device, name, own_stream)
    if exec_cache.setdefault("signature", sig) != sig:
        raise ValueError(
            "exec_cache shared across differently-configured tickers: "
            f"{exec_cache['signature']} vs {sig}")
    if "shared" not in exec_cache:
        exec_cache["shared"] = Programs(device, name, own_stream)
    return exec_cache["shared"]


class _Drain:
    """The finalize drain's one-row state (a row is copied in per drain),
    the lock that serializes drains over it and, on the card, the stream
    they run on: shared, as the drain's program, by the tickers of one
    `exec_cache`."""

    def __init__(self, cfg, ocfg, partials: bool, device: torch.device):
        with torch.inference_mode():
            self.state = po.init_fused_state(cfg, ocfg, 1, partials, device)
        self.lock = threading.Lock()
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)


class _Taken(NamedTuple):
    """A slot taken for its drain (`BatchedChunkedASR.take_slot`)."""
    slot: int
    fired: Dict[int, list]           # every row's carried results
    state: Dict[str, torch.Tensor]   # the slot's state row, copied
    audio: np.ndarray                # its audio remainder
    ready: Optional["torch.cuda.Event"]   # recorded after the copy


class AtCapacity(RuntimeError):
    """All ticker rows are claimed. A dedicated type, so the serving layer's
    degrade-to-per-session path cannot be triggered by an unrelated
    RuntimeError."""


def _masked_merge(old: torch.Tensor, new: torch.Tensor, keep: torch.Tensor,
                  dim: int) -> None:
    """old[rows where keep] ← new, in place (old may be a strided view)."""
    shape = [1] * old.dim()
    shape[dim] = -1
    torch.where(keep.reshape(shape), new, old, out=old)


class _PackedRows:
    """Slot ↔ row bookkeeping of a packed ticker: live sessions hold the
    rows [0, n_live); external slot ids stay stable while rows move."""

    def __init__(self, capacity: int, name: str):
        self.capacity = capacity
        self.name = name
        self.free = list(range(capacity))
        self.slot_row: Dict[int, int] = {}
        self.row_slot: Dict[int, int] = {}
        self.n_live = 0
        self.lock = threading.Lock()

    def claim(self) -> int:
        """A new session takes the first row past the live prefix (caller
        holds the lock)."""
        if not self.free:
            raise AtCapacity(f"{self.name} ticker at capacity")
        slot = self.free.pop()
        row = self.n_live
        self.slot_row[slot] = row
        self.row_slot[row] = slot
        self.n_live += 1
        return slot

    def release(self, slot: int) -> Tuple[int, Optional[int]]:
        """Drop slot's row keeping the packed invariant (caller holds the
        lock). Returns (row, last): the caller moves row `last` into `row`
        and zeroes `last`, or — when last is None — zeroes `row`."""
        row = self.slot_row.pop(slot)
        self.row_slot.pop(row)
        last = self.n_live - 1
        self.n_live = last
        if row == last:
            return row, None
        moved = self.row_slot.pop(last)
        self.slot_row[moved] = row
        self.row_slot[row] = moved
        return row, last

    def cover(self, slots) -> int:
        """The pow-2 prefix (≤ capacity) covering the rows of `slots`."""
        need = 1 + max(self.slot_row[s] for s in slots)
        return min(_pow2(need), self.capacity)


class _FixedRows(_PackedRows):
    """Slot = row for good (a mesh ticker: rows live on their positions, so
    none moves; an unbucketed or unfused one); every step covers every
    row."""

    def claim(self) -> int:
        if not self.free:
            raise AtCapacity(f"{self.name} ticker at capacity")
        slot = self.free.pop()
        self.slot_row[slot] = self.row_slot[slot] = slot
        self.n_live += 1
        return slot

    def release(self, slot: int) -> Tuple[int, Optional[int]]:
        self.slot_row.pop(slot)
        self.row_slot.pop(slot)
        self.n_live -= 1
        return slot, None

    def cover(self, slots) -> int:
        return self.capacity


class _Shard:
    """One mesh position of a ticker: its device, its replica of the
    weights and CMVN, its rows of the state and its step programs."""

    def __init__(self, device: torch.device, params, cmvn, state,
                 programs: Programs):
        self.device, self.params, self.cmvn = device, params, cmvn
        self.state, self.programs = state, programs


class BatchedChunkedASR:
    """Fixed-capacity batched chunked Paraformer over live sessions.

    S sessions' 240 ms chunks run as one `paraformer_online.fused_step` per
    tick: audio ring → fbank (kernel K2) → LFR → CMVN → chunked encoder (K1
    in every layer) → CIF (→ incremental decode with `partials=True`). Rows
    without a full chunk this tick are masked out of the merge, so joining,
    leaving or starved sessions never touch their state.

    pipelined=True: double-buffered tick dispatch (the reference's serving
    default, parsed from CHUNKED_PIPELINE by the hub): a step's fired
    outputs go by an async copy into one of two pinned host buffers, and
    the host reads them at the next dispatch (or at `leave`, `reset_slot`,
    `take_slot`), so the copy and the host work overlap the next step.
    Results lag one step; the finalize drain returns everything.

    Finalize (`finalize_slot` = `take_slot`, then `drain`; see the module's
    docstring): the drain steps a one-row copy of the slot's state with the
    b = 1 "drain" program, so no drain steps the tick's pow-2 cover, and
    the slot is reset at the take.

    exec_cache: a dict shared by identically configured tickers (the lanes
    of one `LanedHub`). The signature holds capacity, partials, the int16
    upload, both configs, a CMVN fingerprint, the devices and the weights'
    buffers; a mismatch raises ValueError. Each lane's tick programs bind
    its own state rows and are its own; the finalize drain's step, its
    one-row state and lock, and the "tail" decode are shared.

    mesh: rows shard over its "data" axis (see the module's docstring);
    the finalize drain runs on the first position, its row copied there.

    fused=False: the host-frontend ticker (see the module's docstring);
    `partials` and `pipelined` take effect only with `fused`, and
    `finalize_slot` needs it. bucketed (default: fused and no mesh; an
    explicit value is ANDed with that): the packed pow-2 prefix steps;
    off, every step covers every row, slot = row.

    Spans (`runtime/profiling.py`) per step: `ticker.stage` (the cover
    batch built on the host), `ticker.dispatch` (the program call) and
    `ticker.harvest` (the wait on the previous step's copies, and their
    ids handed out). Counters: `steps`, every device step (drains'
    included); `rows_stepped`, the rows the ticks' steps covered, and
    `rows_active`, those of them that carried a chunk; `drains`, the
    finalizes drained, and `drain_steps`, their steps.
    """

    FBANK_QUANTA = 24   # fbank frames per unfused fbank call: one shape

    def __init__(self, params, cfg: Optional[pf.ParaformerConfig] = None,
                 ocfg: Optional[po.OnlineConfig] = None, capacity: int = 16,
                 cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 partials: bool = False, pipelined: bool = False,
                 exec_cache: Optional[dict] = None,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None,
                 fused: bool = True, bucketed: Optional[bool] = None):
        """params: a Paraformer tensor tree (moved to `device`, the card
        unless "cpu" is passed, or to each device of `mesh`'s data axis).
        partials=True also decodes the fired tokens in the same step;
        `tick` then returns per-slot token ids instead of embeddings."""
        if mesh is not None:
            positions = mesh.along("data")
            if capacity % len(positions):
                raise ValueError(f"capacity {capacity} not divisible by "
                                 f"data axis {len(positions)}")
            self.device = positions[0]
        else:
            self.device = resolve_device(device)
            positions = [self.device]
        self.mesh = mesh
        self.cfg = cfg or pf.ParaformerConfig()
        self.ocfg = ocfg or po.OnlineConfig()
        self.capacity = capacity
        self.fused = fused
        self.partials = partials and fused
        self.pipelined = pipelined and fused
        self.bucketed = (fused and mesh is None) if bucketed is None \
            else (bucketed and fused and mesh is None)
        self.params = tree_to(params, self.device)
        self.cmvn = None
        if cmvn is not None:
            self.cmvn = tuple(torch.as_tensor(np.asarray(c, np.float32),
                                              device=self.device)
                              for c in cmvn)
        # the unfused sessions' host frontends take the CMVN as numpy
        self._cmvn_host = None if cmvn is None else tuple(
            np.asarray(c, np.float32) for c in cmvn)
        # int16 upload: an explicit env var wins, else the profile
        self._int16_transfer = env_or_profile("PARAFORMER_TRANSFER_INT16",
                                              "asr_int16_transfer")
        fcfg = self.cfg.frontend
        self.chunk_samples = self.ocfg.c1 * fcfg.lfr_n * fcfg.frame_shift
        if not fused:
            positions = positions[:1]   # the unfused state is not sharded
        self.rows_per = capacity // len(positions)   # rows per position
        self._shards: List[_Shard] = []
        for i, (dev, params_i, cmvn_i) in enumerate(zip(
                positions, per_position(self.params, positions),
                per_position(self.cmvn, positions))):
            with torch.inference_mode():
                state = (po.init_fused_state(self.cfg, self.ocfg,
                                             self.rows_per, self.partials,
                                             dev) if fused
                         else po.init_state(self.cfg, self.ocfg, capacity,
                                            dev))
            self._shards.append(_Shard(
                dev, params_i, cmvn_i, state,
                Programs(dev, "chunked-tick" if i == 0
                         else f"chunked-tick@{i}")))
        self.state = self._shards[0].state
        self.programs = self._shards[0].programs
        self._rows = (_PackedRows if self.bucketed else _FixedRows)(
            capacity, "chunked-ASR")
        self._audio: Dict[int, np.ndarray] = {}
        # unfused: each slot's host frontend and LFR feature queue
        self._frontends: Dict[int, StreamingFrontend] = {}
        self._queues: Dict[int, np.ndarray] = {}
        self.steps = 0            # device steps run (K1 in every layer)
        self.rows_stepped = 0     # rows the ticks' steps covered
        self.rows_active = 0      # of them, rows that carried a chunk
        self.fbanks = 0           # unfused fbank quantum calls (one K2 each)
        self.drains = 0           # finalizes drained on the one-row path
        self.drain_steps = 0      # their steps (also in `steps`)
        self._counts = threading.Lock()   # ticks and drains count apart
        sig = ("chunked", capacity, fused, self.partials, self.bucketed,
               self._int16_transfer, self.cfg, self.ocfg,
               _fingerprint(self.cmvn), tuple(str(d) for d in positions),
               _weights_id(self.params))
        # the drain's graphs run beside the ticks' on a stream of their
        # own: their owner captures on its own side stream too
        self.shared = _share(exec_cache, sig, self.device, "chunked-shared",
                             own_stream=True)
        self._drain = None
        if fused:
            self._drain = (exec_cache or {}).get("drain")
            if self._drain is None:
                self._drain = _Drain(self.cfg, self.ocfg, self.partials,
                                     self.device)
                if exec_cache is not None:
                    exec_cache["drain"] = self._drain
        # the fused step's fired outputs, copied out per dispatch into one
        # of two host buffers (pinned on the card)
        k_cap = self.ocfg.tokens_per_chunk
        pin = self.device.type == "cuda"
        out_shape = ((capacity, k_cap) if self.partials
                     else (capacity, k_cap, self.cfg.d_model))
        out_dtype = torch.int32 if self.partials else torch.float32
        self._host = [] if not fused else [
            (torch.empty(out_shape, dtype=out_dtype, pin_memory=pin),
             torch.empty((capacity,), dtype=torch.int32, pin_memory=pin))
            for _ in range(2)]
        self._flip = 0
        # (slot → row of the dispatch, (outputs, counts, event))
        self._inflight: Optional[Tuple[Dict[int, int], tuple]] = None
        self._carry: Dict[int, list] = {}

    # ------------------------------------------------------------ rows
    @property
    def n_live(self) -> int:
        return self._rows.n_live

    def row_of(self, slot: int) -> int:
        """Device row a slot currently owns."""
        return self._rows.slot_row[slot]

    def _at(self, row: int) -> Tuple[Dict[str, torch.Tensor], int]:
        """(state of the position holding `row`, the row there)."""
        shard = self._shards[row // self.rows_per]
        return shard.state, row % self.rows_per

    @torch.inference_mode()
    def _zero_row(self, row: int) -> None:
        state, row = self._at(row)
        for key, a in state.items():
            a.select(po.batch_dim(key), row).zero_()

    @torch.inference_mode()
    def _move_row(self, src: int, dst: int) -> None:
        """Copy row src → dst, then zero src (the vacated tail row must not
        leak a finished session's caches into a masked prefix step); the
        packed path's, whose rows share one position."""
        for key, a in self.state.items():
            d = po.batch_dim(key)
            a.select(d, dst).copy_(a.select(d, src))
            a.select(d, src).zero_()

    def join(self) -> int:
        with self._rows.lock:
            slot = self._rows.claim()
        try:
            if not self.fused:
                self._frontends[slot] = StreamingFrontend(
                    self.cfg.frontend, self._cmvn_host, self.device)
                self._queues[slot] = self._no_feats()
            self._audio[slot] = np.zeros(0, np.float32)
            self._reset_slot(slot)
        except BaseException:
            # setup failed: the row is clean state-wise, so return it
            with self._rows.lock:
                self._frontends.pop(slot, None)
                self._queues.pop(slot, None)
                self._audio.pop(slot, None)
                try:
                    self._release_row_locked(slot)
                except BaseException:
                    logger.exception("row release after failed join")
                self._rows.free.append(slot)
            raise
        return slot

    def _release_row_locked(self, slot: int) -> None:
        row, last = self._rows.release(slot)
        if last is None:
            self._zero_row(row)
        else:
            self._move_row(last, row)

    def _drop_results(self, slot: int) -> None:
        """Read the in-flight step and drop this slot's results (the other
        rows' carried results flow out with the next tick)."""
        if self._inflight is not None or self._carry:
            self._harvest()
            self._carry.pop(slot, None)

    def leave(self, slot: int) -> None:
        self._drop_results(slot)
        with self._rows.lock:
            self._frontends.pop(slot, None)
            self._queues.pop(slot, None)
            self._audio.pop(slot, None)
            self._release_row_locked(slot)
            self._rows.free.append(slot)

    def _reset_slot(self, slot: int) -> None:
        self._zero_row(self.row_of(slot))

    def _no_feats(self) -> np.ndarray:
        return np.zeros((0, self.cfg.input_dim), np.float32)

    def reset_slot(self, slot: int) -> None:
        """Session reset: the device state row, the host audio remainder
        and, unfused, the host frontend and feature queue."""
        self._drop_results(slot)
        self._reset_slot(slot)
        self._audio[slot] = np.zeros(0, np.float32)
        if not self.fused:
            frontend = self._frontends.get(slot)
            if frontend is not None:
                frontend.reset()
            self._queues[slot] = self._no_feats()

    def warm(self) -> None:
        """Build the step program of every pow-2 prefix up to capacity (not
        bucketed: each position's full step), and the finalize drain's step
        and tail, so no tick or drain waits on a build (on the card: a
        capture, which runs all-masked steps and leaves the state as it
        was). The unfused ticker builds nothing here, as the reference's."""
        if not self.fused:
            return
        if not self.bucketed:
            for i in range(len(self._shards)):
                self._tick_fn(self.rows_per, i)
        else:
            b = 1
            while True:
                b = min(b, self.capacity)
                self._tick_fn(b)
                if b == self.capacity:
                    break
                b *= 2
        self._drain_fn()
        if self.partials:
            self._tail_fn()

    # ------------------------------------------------------------ step
    def _step(self, shard: _Shard, sub: Dict[str, torch.Tensor]):
        """The fused step over the state rows `sub` with `shard`'s weights,
        as a program's (function, inputs): audio [b, chunk] and row
        activity [b] → (fired ids [b, k_cap] int32 or embeddings
        [b, k_cap, d] f32, fired counts [b] int32), `sub` merged in place
        for the active rows."""
        int16_in = self._int16_transfer
        b = sub["cif_mass"].shape[0]

        def run(audio, active):
            if int16_in:
                audio = from_int16_pcm(audio)
            res = po.fused_step(shard.params, sub, audio, self.cfg,
                                self.ocfg, cmvn=shard.cmvn,
                                k_cap=self.ocfg.tokens_per_chunk,
                                decode_partials=self.partials)
            keep = active.bool()
            for key, new in res[0].items():
                _masked_merge(sub[key], new, keep, po.batch_dim(key))
            n = res[2].int() * active.int()
            out = res[3].int() if self.partials else res[1].float()
            return out, n
        return run, [((b, self.chunk_samples),
                      torch.int16 if int16_in else torch.float32),
                     ((b,), torch.float32)]

    def _tick_fn(self, b: int, pos: int = 0):
        """The step program of the prefix of b rows of mesh position `pos`
        (ref `_prefix_exec`, `_full_exec`; see `_step`)."""
        shard = self._shards[pos]
        return shard.programs.get(("tick", b), lambda: self._step(
            shard, {k: a.narrow(po.batch_dim(k), 0, b)
                    for k, a in shard.state.items()}))

    def _drain_fn(self):
        """The finalize drain's step (see `_step`): one row, the first
        position's weights, over the drain's one-row state; it reads no
        lane's state, so it is shared through `exec_cache`."""
        return self.shared.get(("drain", 1), lambda: self._step(
            self._shards[0], self._drain.state))

    def _tail_fn(self):
        """The finalize tail (ref "tail"): one CIF embedding [1, 1, d] and
        a row's decoder state (copied in) → its greedy id [1, 1]."""
        def build():
            shapes = []
            for k in po.DECODER_KEYS:
                a = self.state[k]
                shape = list(a.shape)
                shape[po.batch_dim(k)] = 1
                shapes.append((tuple(shape), a.dtype))

            def run(embed, *dstate):
                one = torch.ones((1,), dtype=torch.int32, device=embed.device)
                return po.decode_chunk(self.params,
                                       dict(zip(po.DECODER_KEYS, dstate)),
                                       embed, one, self.cfg)[1]
            return run, [((1, 1, self.cfg.d_model), torch.float32)] + shapes
        return self.shared.get(("tail",), build)

    def _dispatch(self, batch: np.ndarray, row_active: np.ndarray) -> tuple:
        """Run one step over the prefix of len(batch) rows (on a mesh: all
        rows, each position's own); its fired outputs are copied toward
        the host (async on the card). Returns (outputs, counts, the copies'
        events)."""
        b = batch.shape[0]
        self.rows_stepped += b
        self.rows_active += int(np.count_nonzero(row_active))
        host_out, host_n = self._host[self._flip]
        self._flip ^= 1
        if self._int16_transfer:
            batch = to_int16_pcm(batch)
        per = b // len(self._shards) if self.mesh is not None else b
        events, outs, ns = [], [], []
        for i in range(b // per):
            rows = slice(i * per, (i + 1) * per)

            def read(res, rows=rows):
                out, n = res
                if not out.is_cuda:
                    return out.numpy(), n.numpy()
                host_out[rows].copy_(out, non_blocking=True)
                host_n[rows].copy_(n, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                events.append(done)
                return host_out[rows].numpy(), host_n[rows].numpy()
            out, n = self._tick_fn(per, i)(batch[rows], row_active[rows],
                                           read=read)
            outs.append(out)
            ns.append(n)
            with self._counts:
                self.steps += 1
        if events:
            return host_out[:b].numpy(), host_n[:b].numpy(), events
        return np.concatenate(outs), np.concatenate(ns), events

    def _harvest(self) -> None:
        """Read the in-flight step's fired outputs into the carry."""
        if self._inflight is None:
            return
        pos, (out, n, events) = self._inflight
        self._inflight = None
        with profiling.annotate("ticker.harvest"):
            for done in events:
                done.synchronize()
            for s, r in pos.items():
                k = int(n[r])
                if k > 0:
                    got = out[r, :k]
                    self._carry.setdefault(s, []).extend(
                        got.tolist() if self.partials else list(got.copy()))

    # ------------------------------------------------------------ finalize
    def finalize_slot(self, slot: int) -> Dict[int, list]:
        """Drain a slot for its final result (FunASR is_final semantics)
        and reset it: `take_slot`, then `drain`. Returns slot → new ids (or
        embeddings when partials=False) for every row with carried results
        of earlier steps, the slot's drained ids after its own."""
        taken = self.take_slot(slot)
        taken.fired[slot].extend(self.drain(taken))
        return taken.fired

    @torch.inference_mode()
    def take_slot(self, slot: int) -> _Taken:
        """The drain's first half, under the caller's ticker lock: harvest
        the in-flight step (every row's carried results come out), copy the
        slot's state row toward the drain's device (after the step that
        last wrote it, in stream order) and hand its audio remainder over,
        then reset the slot (row zeroed, remainder emptied)."""
        if not self.fused:
            raise ValueError("finalize_slot requires the fused ticker "
                             "(fused=True)")
        self._harvest()
        fired: Dict[int, list] = {slot: []}
        for s, v in self._carry.items():
            fired[s] = v + fired.get(s, [])
        self._carry.clear()
        state, row = self._at(self.row_of(slot))
        copy = {k: a.narrow(po.batch_dim(k), row, 1).to(self.device,
                                                         copy=True)
                for k, a in state.items()}
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        audio = self._audio.get(slot, np.zeros(0, np.float32))
        self._reset_slot(slot)
        self._audio[slot] = np.zeros(0, np.float32)
        return _Taken(slot, fired, copy, audio, ready)

    @torch.inference_mode()
    def drain(self, taken: _Taken) -> list:
        """The drain's second half, outside the ticker lock: pad the
        remainder to whole chunks plus two silence chunks (2·c1 ≥ c2, so
        every real frame passes the encoder lookahead into the CIF active
        region), step the row's copy alone (the "drain" program, under the
        drain lock, on the drain's stream on the card), then apply the
        host-side tail-threshold fire. Returns the slot's new ids (or
        embeddings when partials=False)."""
        a_len = self.chunk_samples
        rem = len(taken.audio)
        audio = np.concatenate([taken.audio, np.zeros(
            (-rem) % a_len + 2 * a_len, np.float32)]).reshape(-1, 1, a_len)
        if self._int16_transfer:
            audio = to_int16_pcm(audio)
        one = np.ones((1,), np.float32)
        prog, drain = self._drain_fn(), self._drain
        new: list = []
        # the stream's card is current too; no stream on the CPU: a no-op
        with drain.lock, torch.cuda.stream(drain.stream):
            if taken.ready is not None:
                drain.stream.wait_event(taken.ready)
            for k, a in drain.state.items():
                a.copy_(taken.state[k])
            fetches = []
            for chunk in audio:
                fetches.append(prog(chunk, one, read=lambda r: (
                    to_host(r[0]), to_host(r[1]))))
                with self._counts:
                    self.steps += 1
                    self.drain_steps += 1
            mass_at = to_host(drain.state["cif_mass"])
            for out, n in fetches:
                out, k = out(), int(n()[0])
                if k > 0:
                    got = out[0, :k]
                    new.extend(got.tolist() if self.partials
                               else list(got.copy()))
            mass = float(mass_at()[0])
            frac = mass - np.floor(mass)
            if frac > 0 and frac + self.cfg.predictor_tail_threshold >= 1.0:
                acc = drain.state["cif_acc"][0]
                if self.partials:
                    ids = self._tail_fn()(
                        acc.float()[None, None, :],
                        *[drain.state[k] for k in po.DECODER_KEYS],
                        read=lambda t: t.cpu().numpy())
                    new.append(int(ids[0, 0]))
                else:   # a copy: the next drain overwrites the state
                    new.append(acc.float().cpu().numpy().copy())
        with self._counts:
            self.drains += 1
        return new

    # ------------------------------------------------------------ unfused
    def _fbank_quantum_fn(self, n: int):
        """The unfused fbank of n ready rows (ref `_fbank_fns[n]`): audio
        [n, span] f32 → FBANK_QUANTA frames [n, FBANK_QUANTA, n_mels]. It
        reads no state, so it is shared through `exec_cache`."""
        fcfg, q = self.cfg.frontend, self.FBANK_QUANTA
        span = (q - 1) * fcfg.frame_shift + fcfg.frame_length

        def build():
            return ((lambda a: fe.fbank(a, fcfg, t_frames=q)),
                    [((n, span), torch.float32)])
        return self.shared.get(("fbank", n), build)

    def _batched_fbank(self, slots: List[int]) -> None:
        """One fbank call per quantum over every ready slot of `slots`; each
        session's frontend then drains LFR on the host into its queue. The
        upload stays f32 whatever PARAFORMER_TRANSFER_INT16 says, as the
        reference's."""
        fcfg, q = self.cfg.frontend, self.FBANK_QUANTA
        span = (q - 1) * fcfg.frame_shift + fcfg.frame_length
        consume = q * fcfg.frame_shift
        while True:
            ready = [s for s in slots if len(self._audio[s]) >= span]
            if not ready:
                return
            batch = np.stack([self._audio[s][:span] for s in ready])
            fb = self._fbank_quantum_fn(len(ready))(
                batch, read=lambda t: t.cpu().numpy())
            self.fbanks += 1
            for i, s in enumerate(ready):
                self._audio[s] = self._audio[s][consume:]
                feats = self._frontends[s].push_fbank(fb[i])
                if len(feats):
                    self._queues[s] = np.concatenate([self._queues[s], feats])

    def _unfused_fn(self):
        """The unfused step over all `capacity` rows (ref `_step`): LFR
        features [capacity, c1, input_dim] and row activity [capacity] →
        (fired embeddings [capacity, k_cap, d] f32, fired counts [capacity]
        int32); `encode_chunk`, then `predictor_chunk` over the window's
        active region, every state leaf merged in place for the active
        rows."""
        shard = self._shards[0]
        c, o = self.cfg, self.ocfg

        def build():
            state = shard.state
            active_win = torch.zeros((o.window,), device=shard.device)
            active_win[o.c0:o.c0 + o.c1] = 1.0

            def run(feats, row_active):
                new, enc = po.encode_chunk(shard.params, state, feats, c, o)
                active = active_win[None, :] * row_active[:, None]
                new, embeds, n = po.predictor_chunk(
                    shard.params, enc, active, new, c, o.tokens_per_chunk)
                keep = row_active.bool()
                for key, a in new.items():
                    _masked_merge(state[key], a, keep, po.batch_dim(key))
                return embeds.float(), n.int() * row_active.int()
            return run, [((self.capacity, o.c1, c.input_dim), torch.float32),
                         ((self.capacity,), torch.float32)]
        return shard.programs.get(("unfused", self.capacity), build)

    def _tick_unfused(self, chunks: Dict[int, np.ndarray],
                      fired: Dict[int, list]) -> Dict[int, list]:
        """The unfused tick (ref `tick`'s second half): the batched fbank of
        this tick's slots, then a full-capacity step while any queue holds
        c1 frames. Its spans: `ticker.stage` (the fbank calls with the host
        LFR drain, and each step's batch), `ticker.dispatch` (the step and
        its fetch, which waits for the card) and `ticker.harvest` (the
        fired embeddings handed to their slots)."""
        with profiling.annotate("ticker.stage"):
            self._batched_fbank(list(chunks))
        c1, d_in = self.ocfg.c1, self.cfg.input_dim
        while True:
            slots = [s for s, q in self._queues.items() if len(q) >= c1]
            if not slots:
                return fired
            with profiling.annotate("ticker.stage"):
                batch = np.zeros((self.capacity, c1, d_in), np.float32)
                row_active = np.zeros((self.capacity,), np.float32)
                for s in slots:                  # slot = row
                    batch[s] = self._queues[s][:c1]
                    self._queues[s] = self._queues[s][c1:]
                    row_active[s] = 1.0
            with profiling.annotate("ticker.dispatch"):
                embeds, n = self._unfused_fn()(
                    batch, row_active,
                    read=lambda r: (r[0].cpu().numpy(), r[1].cpu().numpy()))
            self.steps += 1
            self.rows_stepped += self.capacity
            self.rows_active += len(slots)
            with profiling.annotate("ticker.harvest"):
                for s in slots:
                    if n[s] > 0:
                        fired.setdefault(s, []).extend(embeds[s, :n[s]])

    # ------------------------------------------------------------ tick
    def tick(self, chunks: Dict[int, np.ndarray]) -> Dict[int, list]:
        """chunks: slot → new audio. Returns slot → the CIF-fired token
        embeddings (or token ids with partials=True) that became available
        this tick, which may run several steps; pipelined, a step's results
        arrive one dispatch later."""
        for slot, audio in chunks.items():
            self._audio[slot] = np.concatenate(
                [self._audio.get(slot, np.zeros(0, np.float32)),
                 np.asarray(audio, np.float32)])
        fired: Dict[int, list] = {s: [] for s in chunks}
        if not self.fused:
            return self._tick_unfused(chunks, fired)
        a_len = self.chunk_samples
        while True:
            slots = [s for s, a in self._audio.items() if len(a) >= a_len]
            if not slots:
                break
            with profiling.annotate("ticker.stage"):
                # the pow-2 cover of the highest ready row (≤ n_live); rows
                # in the prefix without a chunk ride along masked
                bucket = self._rows.cover(slots)
                batch = np.zeros((bucket, a_len), np.float32)
                row_active = np.zeros((bucket,), np.float32)
                pos = {}
                for s in slots:
                    r = self.row_of(s)
                    batch[r] = self._audio[s][:a_len]
                    self._audio[s] = self._audio[s][a_len:]
                    row_active[r] = 1.0
                    pos[s] = r
            with profiling.annotate("ticker.dispatch"):
                res = self._dispatch(batch, row_active)
            self._harvest()                 # the previous dispatch's outputs
            self._inflight = (pos, res)
            if not self.pipelined:
                self._harvest()             # this dispatch's, now
        if self._carry:
            for s, v in self._carry.items():
                # carried results are older than this tick's
                fired[s] = v + fired.get(s, [])
            self._carry.clear()
        return fired


class BatchedVadTicker:
    """Fixed-capacity batched FSMN-VAD stepper over live sessions.

    Sessions submit chunks each tick; `tick()` computes the fbank of all of
    them in one program run per length bucket (kernel K2), drains LFR per
    session on the host, and runs `fsmn_vad.apply_streaming` (K1 in each of
    its layers) once per group of rows that emitted the same number of
    frames. The conv caches are one tensor [layers, capacity, lorder − 1,
    proj], packed like BatchedChunkedASR's rows. Each (pow-2 rows, frames)
    step is a program bound to its prefix of the cache; each (pow-2 rows,
    length bucket) fbank is a program that reads no state, shared through
    `exec_cache` (signature: capacity, the int16 upload, config, CMVN
    fingerprint, device).
    """

    LEN_QUANTUM = 1600       # 0.1 s buckets of buffered length
    MAX_PASS = 1600 * 64     # 6.4 s per fbank pass; longer buffers loop

    def __init__(self, params, cfg: Optional[fsmn_vad.FsmnVadConfig] = None,
                 capacity: int = 16, threshold: float = 0.5, cmvn=None,
                 exec_cache: Optional[dict] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg or fsmn_vad.FsmnVadConfig()
        self.params = tree_to(params, self.device)
        self.threshold = threshold
        self.cmvn = cmvn
        self.capacity = capacity
        with torch.inference_mode():
            self.cache = fsmn_vad.init_cache(capacity, self.cfg, self.device)
        self._rows = _PackedRows(capacity, "VAD")
        self._frontends: Dict[int, StreamingFrontend] = {}
        self._audio: Dict[int, np.ndarray] = {}   # per-slot raw-sample tails
        self.fbanks = 0   # fbank passes run (one K2 each)
        self.steps = 0    # FSMN steps run (K1 in each layer)
        # int16 upload of the fbank rows: an explicit env var wins, else
        # the profile
        self._int16_transfer = env_or_profile("PARAFORMER_TRANSFER_INT16",
                                              "asr_int16_transfer")
        self.programs = Programs(self.device, "vad-step")
        sig = ("vad", capacity, self._int16_transfer, self.cfg,
               _fingerprint(cmvn), str(self.device))
        self.shared = _share(exec_cache, sig, self.device, "vad-fbank")

    # ------------------------------------------------------------ rows
    @property
    def n_live(self) -> int:
        return self._rows.n_live

    def row_of(self, slot: int) -> int:
        return self._rows.slot_row[slot]

    def join(self) -> int:
        """Claim a session row; returns the slot id."""
        with self._rows.lock:
            slot = self._rows.claim()
        try:
            self._frontends[slot] = StreamingFrontend(self.cfg.frontend,
                                                      self.cmvn, self.device)
            self._audio[slot] = np.zeros(0, np.float32)
            self._reset_slot(slot)
        except BaseException:
            with self._rows.lock:   # setup error: return the row
                self._frontends.pop(slot, None)
                self._audio.pop(slot, None)
                try:
                    self._release_row_locked(slot)
                except BaseException:
                    logger.exception("row release after failed VAD join")
                self._rows.free.append(slot)
            raise
        return slot

    @torch.inference_mode()
    def _release_row_locked(self, slot: int) -> None:
        row, last = self._rows.release(slot)
        if last is not None:
            self.cache[:, row].copy_(self.cache[:, last])
            row = last
        self.cache[:, row].zero_()

    def leave(self, slot: int) -> None:
        with self._rows.lock:
            self._frontends.pop(slot, None)
            self._audio.pop(slot, None)
            self._release_row_locked(slot)
            self._rows.free.append(slot)

    @torch.inference_mode()
    def _reset_slot(self, slot: int) -> None:
        self.cache[:, self.row_of(slot)].zero_()

    def reset_slot(self, slot: int) -> None:
        """Session reset: conv caches and the incremental frontend."""
        self._reset_slot(slot)
        self._audio[slot] = np.zeros(0, np.float32)
        fe_ = self._frontends.get(slot)
        if fe_ is not None:
            fe_.reset()

    # ------------------------------------------------------------ programs
    def _fbank_fn(self, nb: int, lb: int):
        """The fbank of nb rows of lb samples (ref ("fb", nb, lb))."""
        int16_in = self._int16_transfer

        def build():
            fcfg = self.cfg.frontend
            t = fe.num_fbank_frames(lb, fcfg)

            def run(a):
                if int16_in:
                    a = from_int16_pcm(a)
                return fe.fbank(a, fcfg, t_frames=t)
            return run, [((nb, lb),
                          torch.int16 if int16_in else torch.float32)]
        return self.shared.get(("fb", nb, lb), build)

    def _step_fn(self, nb: int, n: int):
        """The FSMN step of the cache prefix of nb rows over n frames (ref
        ("p", nb, n)): features [nb, n, D] and group membership [nb] →
        P(speech) [nb, n], the cache prefix merged in place for the rows
        in the group."""
        def build():
            sub = self.cache[:, :nb]

            def run(feats, in_group):
                post, new = fsmn_vad.apply_streaming(self.params, feats, sub,
                                                     self.cfg)
                _masked_merge(sub, new, in_group, 1)
                return fsmn_vad.speech_prob(post, self.cfg)
            return run, [((nb, n, self.cfg.input_dim), torch.float32),
                         ((nb,), torch.bool)]
        return self.programs.get(("p", nb, n), build)

    def warm(self, chunk_samples: int = 6400, ticks: int = 4) -> None:
        """Build every program that `ticks` ticks of uniform chunks of
        `chunk_samples` reach at every pow-2 row count up to capacity (the
        first ticks' fbank lengths and frame counts differ from the steady
        state's), so sessions at a new occupancy wait on no build."""
        fcfg = self.cfg.frontend
        q = self.LEN_QUANTUM
        frontend = StreamingFrontend(fcfg, None, torch.device("cpu"))
        plan = set()
        rem = 0
        for _ in range(ticks):
            length = min(rem + chunk_samples, self.MAX_PASS)
            n_fb = fe.num_fbank_frames(length, fcfg)
            lb = min(-(-length // q) * q, self.MAX_PASS)
            rem = length - n_fb * fcfg.frame_shift
            n = len(frontend.push_fbank(np.zeros((n_fb, fcfg.n_mels),
                                                 np.float32)))
            plan.add((lb, n))
        nb = 1
        while True:
            nb = min(nb, self.capacity)
            for lb, n in sorted(plan):
                self._fbank_fn(nb, lb)
                if n > 0:
                    self._step_fn(nb, n)
            if nb == self.capacity:
                return
            nb *= 2

    # ------------------------------------------------------------ features
    def _batched_feats(self, slots) -> Dict[int, np.ndarray]:
        """One fbank call per LENGTH BUCKET (a uniform chunk cadence gives
        exactly one): buffered lengths pad up to LEN_QUANTUM buckets, rows
        pack into a pow-2 batch, and each row keeps only the frames its
        real samples cover, so the features equal a per-session frontend's
        (zero padding only extends past the last complete frame)."""
        fcfg = self.cfg.frontend
        q, max_pass = self.LEN_QUANTUM, self.MAX_PASS
        parts: Dict[int, list] = {s: [] for s in slots}
        pending = list(slots)
        while True:
            todo = []
            for s in pending:
                length = min(len(self._audio[s]), max_pass)
                if fe.num_fbank_frames(length, fcfg) > 0:
                    todo.append((s, length))
            if not todo:
                break
            by_bucket: Dict[int, list] = {}
            for s, length in todo:
                lb = min(-(-length // q) * q, max_pass)
                by_bucket.setdefault(lb, []).append((s, length))
            for lb, rows in by_bucket.items():
                nb = min(_pow2(len(rows)), self.capacity)
                batch = np.zeros((nb, lb), np.float32)
                for i, (s, length) in enumerate(rows):
                    batch[i, :length] = self._audio[s][:length]
                if self._int16_transfer:
                    batch = to_int16_pcm(batch)
                fb = self._fbank_fn(nb, lb)(
                    batch, read=lambda t: t.cpu().numpy())
                self.fbanks += 1
                for i, (s, length) in enumerate(rows):
                    n = fe.num_fbank_frames(length, fcfg)
                    self._audio[s] = self._audio[s][n * fcfg.frame_shift:]
                    parts[s].append(fb[i, :n])
        empty = np.zeros((0, fcfg.n_mels), np.float32)
        return {s: self._frontends[s].push_fbank(
                    np.concatenate(p) if p else empty)
                for s, p in parts.items()}

    # ------------------------------------------------------------ tick
    def tick(self, chunks: Dict[int, np.ndarray]) -> Dict[int, bool]:
        """chunks: slot → audio chunk → slot → speech in this chunk. One
        batched fbank and one batched FSMN step per distinct size (with
        uniform chunk sizes, exactly one of each)."""
        if not chunks:
            return {}
        for slot, audio in chunks.items():
            self._audio[slot] = np.concatenate(
                [self._audio.get(slot, np.zeros(0, np.float32)),
                 np.asarray(audio, np.float32)])
        feats = self._batched_feats(list(chunks))
        out = {slot: False for slot in chunks}
        # group rows by emitted frame count; rows outside a group keep
        # their cache. Each group steps the pow-2 prefix that covers its
        # highest row, merged in place where the row is in the group.
        d_in = self.cfg.input_dim
        for n in sorted({len(f) for f in feats.values() if len(f) > 0}):
            slots = [s for s, f in feats.items() if len(f) == n]
            nb = self._rows.cover(slots)
            batch = np.zeros((nb, n, d_in), np.float32)
            in_group = np.zeros((nb,), bool)
            for s in slots:
                batch[self.row_of(s)] = feats[s]
                in_group[self.row_of(s)] = True
            probs = self._step_fn(nb, n)(batch, in_group,
                                         read=lambda t: t.cpu().numpy())
            self.steps += 1
            for s in slots:
                out[s] = bool((probs[self.row_of(s)] > self.threshold).any())
        return out
