"""Batched multi-session streaming: many connections, one step per tick.

Port of `toolbox_for_asr_and_tts_tpu/parallel/stream_batcher.py`, in its
single-card form. Session states are stacked tensors ([S, …] rows, the
stacked caches [layers, S, …]); live sessions occupy the contiguous row
prefix [0, n_live) — `leave` moves the last live row into the vacated one —
so a tick steps the pow-2 prefix that covers its highest ready row and
writes the result back into the state in place, masked to the rows that had
a chunk (`torch.where(..., out=)` into the prefix view; the reference's
donated `dynamic_update_slice`).

Left out against the reference: the mesh path, `pipelined` dispatch,
`exec_cache` sharing and the compile lock (JAX compile mechanics), the int16
upload (a knob for the TPU's host link) and the unfused `fused=False` path.
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import fsmn_vad
from ..models import paraformer as pf
from ..models import paraformer_online as po
from ..models.convert import tree_to
from ..models.paraformer_streaming import StreamingFrontend
from ..ops import frontend as fe

logger = logging.getLogger("toolbox.stream_batcher")


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


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


class BatchedChunkedASR:
    """Fixed-capacity batched chunked Paraformer over live sessions.

    S sessions' 240 ms chunks run as one `paraformer_online.fused_step` per
    tick: audio ring → fbank (kernel K2) → LFR → CMVN → chunked encoder (K1
    in every layer) → CIF (→ incremental decode with `partials=True`). Rows
    without a full chunk this tick are masked out of the merge, so joining,
    leaving or starved sessions never touch their state.
    """

    def __init__(self, params, cfg: Optional[pf.ParaformerConfig] = None,
                 ocfg: Optional[po.OnlineConfig] = None, capacity: int = 16,
                 cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 partials: bool = False, device: DeviceLike = None):
        """params: a Paraformer tensor tree (moved to `device`, the card
        unless "cpu" is passed). partials=True also decodes the fired
        tokens in the same step; `tick` then returns per-slot token ids
        instead of embeddings."""
        self.device = resolve_device(device)
        self.cfg = cfg or pf.ParaformerConfig()
        self.ocfg = ocfg or po.OnlineConfig()
        self.capacity = capacity
        self.partials = partials
        self.params = tree_to(params, self.device)
        self.cmvn = None
        if cmvn is not None:
            self.cmvn = tuple(torch.as_tensor(np.asarray(c, np.float32),
                                              device=self.device)
                              for c in cmvn)
        fcfg = self.cfg.frontend
        self.chunk_samples = self.ocfg.c1 * fcfg.lfr_n * fcfg.frame_shift
        with torch.inference_mode():
            self.state = po.init_fused_state(self.cfg, self.ocfg, capacity,
                                             partials, self.device)
        self._rows = _PackedRows(capacity, "chunked-ASR")
        self._audio: Dict[int, np.ndarray] = {}
        self.steps = 0            # device steps run (one fused_step each)

    # ------------------------------------------------------------ rows
    @property
    def n_live(self) -> int:
        return self._rows.n_live

    def row_of(self, slot: int) -> int:
        """Device row a slot currently owns."""
        return self._rows.slot_row[slot]

    @torch.inference_mode()
    def _zero_row(self, row: int) -> None:
        for key, a in self.state.items():
            a.select(po.batch_dim(key), row).zero_()

    @torch.inference_mode()
    def _move_row(self, src: int, dst: int) -> None:
        """Copy row src → dst, then zero src (the vacated tail row must not
        leak a finished session's caches into a masked prefix step)."""
        for key, a in self.state.items():
            d = po.batch_dim(key)
            a.select(d, dst).copy_(a.select(d, src))
            a.select(d, src).zero_()

    def join(self) -> int:
        with self._rows.lock:
            slot = self._rows.claim()
        try:
            self._audio[slot] = np.zeros(0, np.float32)
            self._reset_slot(slot)
        except BaseException:
            # setup failed: the row is clean state-wise, so return it
            with self._rows.lock:
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

    def leave(self, slot: int) -> None:
        with self._rows.lock:
            self._audio.pop(slot, None)
            self._release_row_locked(slot)
            self._rows.free.append(slot)

    def _reset_slot(self, slot: int) -> None:
        self._zero_row(self.row_of(slot))

    def reset_slot(self, slot: int) -> None:
        """Session reset: the device state row and the host audio
        remainder."""
        self._reset_slot(slot)
        self._audio[slot] = np.zeros(0, np.float32)

    def warm(self) -> None:
        """Run one all-masked step at every pow-2 prefix up to capacity,
        so the first tick at each occupancy finds the kernels built and the
        library plans made. The state is unchanged."""
        b = 1
        while True:
            b = min(b, self.capacity)
            self._step(np.zeros((b, self.chunk_samples), np.float32),
                       np.zeros((b,), np.float32))
            if b == self.capacity:
                return
            b *= 2

    # ------------------------------------------------------------ step
    @torch.inference_mode()
    def _step(self, batch: np.ndarray, row_active: np.ndarray):
        """One fused_step over the prefix of len(batch) rows, merged into
        the state in place for the active rows. Returns the host copies of
        (embeds f32 or ids, n_fired)."""
        b = batch.shape[0]
        dev = self.device
        audio = torch.from_numpy(batch).to(dev)
        active = torch.from_numpy(row_active).to(dev)
        sub = {k: a.narrow(po.batch_dim(k), 0, b) for k, a in self.state.items()}
        res = po.fused_step(self.params, sub, audio, self.cfg, self.ocfg,
                            cmvn=self.cmvn, k_cap=self.ocfg.tokens_per_chunk,
                            decode_partials=self.partials)
        keep = active.bool()
        for key, new in res[0].items():
            _masked_merge(sub[key], new, keep, po.batch_dim(key))
        n = res[2] * active.int()
        self.steps += 1
        out = res[3] if self.partials else res[1].float()
        return out.cpu().numpy(), n.cpu().numpy()

    # ------------------------------------------------------------ finalize
    @torch.inference_mode()
    def finalize_slot(self, slot: int) -> Dict[int, list]:
        """Drain a slot for its final result (FunASR is_final semantics):
        pad its audio remainder to whole chunks plus two silence chunks
        (2·c1 ≥ c2, so every real frame passes the encoder lookahead into
        the CIF active region), run the steps, then apply the host-side
        tail-threshold fire. Returns slot → new ids (or embeddings when
        partials=False) for every row the drain advanced. The slot's state
        is not reset here; callers follow with reset_slot or leave."""
        a_len = self.chunk_samples
        rem = len(self._audio.get(slot, ()))
        pad = (-rem) % a_len + 2 * a_len
        fired = self.tick({slot: np.zeros(pad, np.float32)})
        row = self.row_of(slot)
        mass = float(self.state["cif_mass"][row])
        frac = mass - np.floor(mass)
        if frac > 0 and frac + self.cfg.predictor_tail_threshold >= 1.0:
            acc = self.state["cif_acc"][row]
            if self.partials:
                dstate = {k: self.state[k].narrow(po.batch_dim(k), row, 1)
                          for k in po.DECODER_KEYS}
                one = torch.ones((1,), dtype=torch.int32, device=self.device)
                _, ids = po.decode_chunk(self.params, dstate,
                                         acc[None, None, :], one, self.cfg)
                fired.setdefault(slot, []).append(int(ids[0, 0]))
            else:
                fired.setdefault(slot, []).append(acc.float().cpu().numpy())
        return fired

    # ------------------------------------------------------------ tick
    def tick(self, chunks: Dict[int, np.ndarray]) -> Dict[int, list]:
        """chunks: slot → new audio. Returns slot → the CIF-fired token
        embeddings (or token ids with partials=True) of this tick, which may
        run several steps."""
        for slot, audio in chunks.items():
            self._audio[slot] = np.concatenate(
                [self._audio.get(slot, np.zeros(0, np.float32)),
                 np.asarray(audio, np.float32)])
        fired: Dict[int, list] = {s: [] for s in chunks}
        a_len = self.chunk_samples
        while True:
            slots = [s for s, a in self._audio.items() if len(a) >= a_len]
            if not slots:
                return fired
            # the pow-2 cover of the highest ready row (≤ n_live); rows in
            # the prefix without a chunk ride along masked
            bucket = self._rows.cover(slots)
            batch = np.zeros((bucket, a_len), np.float32)
            row_active = np.zeros((bucket,), np.float32)
            for s in slots:
                r = self.row_of(s)
                batch[r] = self._audio[s][:a_len]
                self._audio[s] = self._audio[s][a_len:]
                row_active[r] = 1.0
            out, n = self._step(batch, row_active)
            for s in slots:
                r = self.row_of(s)
                if n[r] > 0:
                    got = out[r, : n[r]]
                    fired.setdefault(s, []).extend(
                        got.tolist() if self.partials else list(got))


class BatchedVadTicker:
    """Fixed-capacity batched FSMN-VAD stepper over live sessions.

    Sessions submit chunks each tick; `tick()` computes the fbank of all of
    them in one call per length bucket (kernel K2), drains LFR per session
    on the host, and runs `fsmn_vad.apply_streaming` (K1 in each of its
    layers) once per group of rows that emitted the same number of frames.
    The conv caches are one tensor [layers, capacity, lorder − 1, proj],
    packed like BatchedChunkedASR's rows.
    """

    LEN_QUANTUM = 1600       # 0.1 s buckets of buffered length
    MAX_PASS = 1600 * 64     # 6.4 s per fbank pass; longer buffers loop

    def __init__(self, params, cfg: Optional[fsmn_vad.FsmnVadConfig] = None,
                 capacity: int = 16, threshold: float = 0.5, cmvn=None,
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

    # ------------------------------------------------------------ features
    @torch.inference_mode()
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
                fb = fe.fbank(torch.from_numpy(batch).to(self.device), fcfg,
                              t_frames=fe.num_fbank_frames(lb, fcfg))
                self.fbanks += 1
                fb = fb.cpu().numpy()
                for i, (s, length) in enumerate(rows):
                    n = fe.num_fbank_frames(length, fcfg)
                    self._audio[s] = self._audio[s][n * fcfg.frame_shift:]
                    parts[s].append(fb[i, :n])
        empty = np.zeros((0, fcfg.n_mels), np.float32)
        return {s: self._frontends[s].push_fbank(
                    np.concatenate(p) if p else empty)
                for s, p in parts.items()}

    # ------------------------------------------------------------ tick
    @torch.inference_mode()
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
            sub = self.cache[:, :nb]
            post, new = fsmn_vad.apply_streaming(
                self.params, torch.from_numpy(batch).to(self.device), sub,
                self.cfg)
            self.steps += 1
            _masked_merge(sub, new, torch.from_numpy(in_group).to(self.device),
                          1)
            probs = fsmn_vad.speech_prob(post, self.cfg).cpu().numpy()
            for s in slots:
                out[s] = bool((probs[self.row_of(s)] > self.threshold).any())
        return out
