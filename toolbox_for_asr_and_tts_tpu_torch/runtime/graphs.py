"""One captured CUDA graph per program bucket.

The port's counterpart of the reference's `jax.jit(run).lower(...).compile()`
per shape. A model call that the reference compiles once per shape bucket
(a recognizer forward, a streaming tick, a KWS batch, ...) is a `Program`
here: on the card, one `torch.cuda.CUDAGraph` captured from the eager
function at the bucket's shapes and replayed with static input and output
buffers; on the CPU, the eager function itself, with no capture. Both run
behind the same cache, keys and locks, so the CPU tests exercise them.
The fine-tuning step's programs (`runtime/train_graph.py::TrainProgram`)
are of this layer too: forward, autograd and the optimizer in one graph
per batch shape, on an owner of their own.

`Programs` is one owner's cache (one recognizer, one ticker, one spotter,
or one mesh position of a recognizer or a ticker, since a graph binds its
own position's buffers). An owner belongs to one card: its builds and
replays make that card current, so its side stream, its pool's segments
and its events are that card's whichever card the caller had current:
- a double-checked lookup by bucket key; the build runs under the
  process-wide `COMPILE_LOCK` (`runtime/compile_lock.py`);
- a build makes the static inputs, runs the function eagerly on the
  capture's side stream (so cuBLAS, cuFFT and cuDNN make their handles,
  plans and workspaces outside the capture, as PyTorch's CUDA-graph notes
  require), then captures it there with `capture_error_mode=
  "thread_local"`: other threads may go on launching and fetching on
  their own streams during a capture, which only the capturing thread's
  calls can invalidate. A graph binds the cuBLAS workspace of the handle
  and stream it was captured on, so graphs captured on one side stream
  must not run at once: an owner whose graphs are replayed beside other
  owners' on another stream (the chunked finalize drain's) is made with
  `own_stream=True` and captures on a side stream of its own;
- every program of one owner allocates from one graph memory pool, and the
  owner's replays are serialized by one lock (`Programs.lock`), held from
  the copy into the static inputs through the copy out of the static
  outputs: a graph's static buffers make it non-reentrant, where a compiled
  XLA executable is reentrant. The pool then holds about the largest
  program's working set plus every program's static outputs, not the sum
  of their peaks;
- inputs given as numpy arrays go through pinned host staging buffers
  (`copy_(..., non_blocking=True)`); inputs given as tensors on the card
  are copied on the card. Buffers a program binds for good (a ticker's
  state rows, the weights) are not inputs: the graph reads and writes them
  where they are;
- K1, K1's backward and K2 launched while a program is warmed or captured
  are not counted as runs (`ops/kernels/_build.tallied`); the capture's
  launches become the program's tally, which every replay adds to the
  kernels' `launches` counters, so a replay counts what the eager call
  would have counted.

Spans (`runtime/profiling.py`): `program.lock_wait` (the owner's lock),
`program.stage` (`_fill`: the wait on the last staging copies and the
pinned staging), `program.replay` (the launch; on the CPU the eager run)
and `program.fetch` (`to_host`'s wait for the card).

A capture that fails raises; nothing falls back to an eager run on the
card, and there is no switch that turns graphs off there. The owner's
next capture takes a fresh graph pool (`end_capture`: torch takes no
further capture into a failed capture's pool). An owner on the
card resolves the dispatch profile (`runtime/autotune.py`) when it is
made, so a knob read inside a capture never runs the profile's probe.
"""
from __future__ import annotations

import gc
import threading
import time
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.convert import tree_map
from ..ops.kernels import _build, frame_window, fsmn_conv, fsmn_conv_dw
from . import profiling
from .compile_lock import COMPILE_LOCK

WARMUP_RUNS = 1     # eager runs on the capture stream before each capture

Spec = Tuple[Tuple[int, ...], torch.dtype]
# kernel module name → its counter (what a replay adds its tally to)
_COUNTERS = {"fsmn_conv": fsmn_conv.add_launches,
             "fsmn_conv_dw": fsmn_conv_dw.add_launches,
             "frame_window": frame_window.add_launches}
_OWNERS: "weakref.WeakSet[Programs]" = weakref.WeakSet()
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every warm-up and capture on `device` runs on (one
    at a time: captures hold COMPILE_LOCK), so the library workspaces the
    warm-up makes are the capture's."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    return stream


def end_capture(graph: "torch.cuda.CUDAGraph", owner: "Programs") -> None:
    """`graph.capture_end()`. Where it raises (an illegal call, such as a
    host sync, invalidated the capture), torch leaves the allocator
    routing the capture stream's allocations into the owner's pool, and
    that pool takes no further capture: end the routing, give the owner a
    fresh pool for its next capture, then raise."""
    try:
        graph.capture_end()
    except BaseException:
        end = getattr(torch._C, "_cuda_endAllocateToPool", None)
        if end is not None:
            try:
                end(owner.device.index, owner.pool())
            except RuntimeError:     # this torch ended the routing itself
                pass
        owner.retire_pool()
        raise


def capture_graph(owner: "Programs", warm_up: Callable[[], Any],
                  fn: Callable[[], Any]) -> Tuple[Any, Any, Any, Dict]:
    """On the owner's card (current), from the calling thread: run
    `warm_up()` on the capture's side stream, then capture `fn()` there
    into the owner's pool → (graph, warm_up's result, fn's outputs, the
    capture's tally of kernel launches). The launches counted are those
    this thread makes and those any thread makes on the side stream
    (autograd's backward threads). The caller's stream waits for the side
    stream's work."""
    dev = owner.device
    current = torch.cuda.current_stream(dev)
    side = owner.capture_stream()
    side.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    # no collection inside the capture window: a finalizer that touched
    # the card would land in this graph
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(side):
            warm = warm_up()
            # torch.cuda.graph's own entry would synchronize the card and
            # empty the allocator's cache per capture; neither is needed,
            # and both are slow between many captures
            graph.capture_begin(pool=owner.pool(),
                                capture_error_mode="thread_local")
            try:
                with _build.tallied(side.cuda_stream) as tally:
                    out = fn()
            finally:
                end_capture(graph, owner)
    finally:
        if was_enabled:
            gc.enable()
        current.wait_stream(side)
    return graph, warm, out, dict(tally)


def owners() -> List["Programs"]:
    """Every live program cache, in no fixed order (for telemetry)."""
    return list(_OWNERS)


class Program:
    """One bucket's program: `prog(*inputs, read=None)`.

    `read(outputs)` runs under the owner's lock right after the run and its
    result is returned: on the card it must copy out what it keeps (a
    `.cpu()` fetch, a `.clone()`, an async copy into a host buffer), since
    the next replay overwrites the static outputs. Without `read`, the card
    returns a clone of every output and the CPU the eager outputs."""

    def __init__(self, owner: "Programs", key: Hashable,
                 fn: Callable[..., Any], specs: Sequence[Spec]):
        self.owner = owner
        self.key = key
        self.fn = fn
        self.specs = [(tuple(int(n) for n in s), dt) for s, dt in specs]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally: Dict[str, int] = {}   # kernel launches per replay
        self.replays = 0
        self._static_in: List[torch.Tensor] = []
        self._static_out: Any = None
        self._staging: List[Optional[torch.Tensor]] = []
        self._staged: Optional[torch.cuda.Event] = None
        if owner.on_card:
            self._capture()

    # ------------------------------------------------------------ build
    def _capture(self) -> None:
        dev = self.owner.device
        t0 = time.perf_counter()
        # the position's card is current for the whole build, whichever
        # card the calling thread had current: the static buffers, the side
        # stream, the capture and the events all belong to it
        with self.owner.lock, torch.inference_mode(), torch.cuda.device(dev):
            self._static_in = [torch.zeros(s, dtype=dt, device=dev)
                               for s, dt in self.specs]
            self._staging = [None] * len(self.specs)

            def warm_up():
                with _build.tallied():
                    for _ in range(WARMUP_RUNS):
                        self.fn(*self._static_in)
            graph, _, out, tally = capture_graph(
                self.owner, warm_up, lambda: self.fn(*self._static_in))
            self.graph, self._static_out, self.tally = graph, out, tally
        self.owner._count_capture(time.perf_counter() - t0)

    # ------------------------------------------------------------- run
    def _fill(self, args: Sequence[Any]) -> None:
        if len(args) != len(self._static_in):
            raise ValueError(f"program {self.key!r} takes "
                             f"{len(self._static_in)} inputs, got {len(args)}")
        with profiling.annotate("program.stage"):
            if self._staged is not None:
                # the last copies from the staging buffers have finished
                self._staged.synchronize()
            for i, (dst, a) in enumerate(zip(self._static_in, args)):
                shape = tuple(a.shape)
                if shape != tuple(dst.shape):
                    raise ValueError(f"program {self.key!r} input {i}: shape "
                                     f"{shape}, captured {tuple(dst.shape)}")
                if isinstance(a, torch.Tensor):
                    dst.copy_(a, non_blocking=True)
                    continue
                stage = self._staging[i]
                if stage is None:
                    stage = torch.empty(dst.shape, dtype=dst.dtype,
                                        pin_memory=True)
                    self._staging[i] = stage
                stage.numpy()[...] = a
                dst.copy_(stage, non_blocking=True)
            self._staged = torch.cuda.Event()
            self._staged.record()

    def _eager_inputs(self, args: Sequence[Any]) -> List[torch.Tensor]:
        """The CPU's inputs: checked and cast as a capture's static inputs
        would hold them."""
        if len(args) != len(self.specs):
            raise ValueError(f"program {self.key!r} takes {len(self.specs)} "
                             f"inputs, got {len(args)}")
        out = []
        for i, (a, (shape, dt)) in enumerate(zip(args, self.specs)):
            if tuple(a.shape) != shape:
                raise ValueError(f"program {self.key!r} input {i}: shape "
                                 f"{tuple(a.shape)}, built for {shape}")
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.asarray(a))
            out.append(t.to(device=self.owner.device, dtype=dt))
        return out

    def __call__(self, *args: Any, read: Optional[Callable] = None) -> Any:
        owner = self.owner
        with profiling.annotate("program.lock_wait"):
            owner.lock.acquire()
        try:
            if self.graph is None:
                with torch.inference_mode(), \
                        profiling.annotate("program.replay"):
                    out = self.fn(*self._eager_inputs(args))
                if read is None:
                    read = _identity
            else:
                with torch.inference_mode(), torch.cuda.device(owner.device):
                    self._fill(args)
                    with profiling.annotate("program.replay"):
                        self.graph.replay()
                for name, n in self.tally.items():
                    _COUNTERS[name](n)
                out = self._static_out
                if read is None:
                    read = _clone
            self.replays += 1
            owner.replays += 1
            with torch.inference_mode():
                if self.graph is None:
                    return read(out)
                with torch.cuda.device(owner.device):
                    return read(out)
        finally:
            owner.lock.release()


def to_host(t: torch.Tensor):
    """Queue a copy of t to the host; returns a function that waits for it
    and gives the numpy array (a CPU tensor's own array at once). Call it
    inside a program's `read`, where t's card is current."""
    if not t.is_cuda:
        a = t.numpy()
        return lambda: a
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> np.ndarray:
        with profiling.annotate("program.fetch"):
            done.synchronize()
        return host.numpy()
    return wait


def _identity(x: Any) -> Any:
    return x


def _clone(x: Any) -> Any:
    return tree_map(torch.clone, x)


class Programs:
    """One owner's programs by bucket key, with one graph memory pool and
    one replay lock."""

    def __init__(self, device, name: str, own_stream: bool = False):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda": the card current now, fixed for the owner's life
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.name = name
        self.lock = threading.RLock()
        self._progs: Dict[Hashable, Program] = {}
        self._pool = None
        self._retired: List[Any] = []    # pools of failed captures
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.own_stream = own_stream
        self._side: Optional["torch.cuda.Stream"] = None
        if self.on_card:
            from .autotune import get_profile
            get_profile()
        _OWNERS.add(self)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def capture_stream(self) -> "torch.cuda.Stream":
        """The side stream this owner's warm-ups and captures run on: the
        card's shared one, or with `own_stream` one of the owner's own, so
        its graphs bind a cuBLAS workspace no other owner's graph binds."""
        if not self.own_stream:
            return _capture_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def pool(self):
        """The owner's graph memory pool. The handle is only an id: the
        pool's segments are allocated on the card current at the capture,
        which `Program._capture` makes the owner's."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def retire_pool(self) -> None:
        """After a failed capture: the next capture takes a fresh pool;
        the old one stays with the graphs already in it."""
        if self._pool is not None:
            self._retired.append(self._pool)
            self._pool = None

    def get(self, key: Hashable,
            build: Callable[[], Tuple[Callable[..., Any], Sequence[Spec]]],
            make: Callable[..., Program] = Program) -> Program:
        """The program of `key`, built once: `build()` returns the eager
        function and its inputs' (shape, dtype), `make` the program's class
        (a `Program`, or a `train_graph.TrainProgram`). Concurrent first
        calls build it once: the lookup is double-checked under
        COMPILE_LOCK."""
        prog = self._progs.get(key)
        if prog is None:
            with COMPILE_LOCK:
                prog = self._progs.get(key)
                if prog is None:
                    fn, specs = build()
                    prog = make(self, key, fn, specs)
                    self._progs[key] = prog
        return prog

    def __contains__(self, key: Hashable) -> bool:
        return key in self._progs

    def __len__(self) -> int:
        return len(self._progs)

    def __iter__(self):
        return iter(list(self._progs))

    def pop(self, key: Hashable, default: Any = None) -> Any:
        """Drop a program (its graph's memory returns to the pool). With
        the last graph goes the pool: torch releases a pool that no graph
        uses and takes no further capture into it, so the next capture
        takes a fresh one."""
        with COMPILE_LOCK, self.lock:
            prog = self._progs.pop(key, default)
            if all(p.graph is None for p in self._progs.values()):
                self._pool = None
            return prog

    def _count_capture(self, seconds: float) -> None:
        self.captures += 1
        self.capture_s += seconds

    def pool_bytes(self, snapshot: Optional[list] = None) -> Optional[int]:
        """Bytes of the card's memory that this owner's graph pools hold
        (the allocator's segments of the pools); 0 on the CPU, None where
        the allocator's snapshot does not name pools."""
        want = {tuple(p) for p in self._retired + [self._pool]
                if p is not None}
        if not want:
            return 0
        total, named = 0, False
        for seg in (torch.cuda.memory_snapshot() if snapshot is None
                    else snapshot):
            pid = seg.get("segment_pool_id")
            if pid is None:
                continue
            named = True
            if tuple(pid) in want:
                total += int(seg["total_size"])
        return total if named else None

    def stats(self, snapshot: Optional[list] = None) -> Dict[str, Any]:
        return {"owner": self.name, "programs": len(self._progs),
                "captures": self.captures, "capture_s": self.capture_s,
                "replays": self.replays,
                "pool_bytes": self.pool_bytes(snapshot)}


def report() -> List[Dict[str, Any]]:
    """Every live owner's stats, from one allocator snapshot."""
    live = owners()
    snapshot = (torch.cuda.memory_snapshot()
                if any(o._pool is not None or o._retired for o in live)
                else [])
    return [dict(o.stats(snapshot), id=id(o)) for o in live]
