"""The fine-tuning step as one captured CUDA graph per batch shape.

The port's counterpart of the reference's `jax.jit(train_step,
donate_argnums=(0, 1))` (`tools/finetune.py`): `capture_train_step(
train_step, params, opt_state)` returns a step with `train_step`'s
signature and results, with one program per shape of the batch's arrays
((B, T_lfr, D) features, (B, K) targets, ...), as XLA compiles once per
shape. On the card a program is one `torch.cuda.CUDAGraph`: the forward,
K1 and K1's backward, autograd and AdamW in one replay. On the CPU it is
the eager `train_step` behind the same cache and keys, as
`runtime/graphs.py::Programs` is.

The step owns one `Programs` ("train-step": its own graph pool, replay
lock and capture counters, apart from any recognizer's) on the card of the
tree's leaves, and binds the storages it was made with, as the reference
donates them: the leaves and the optimizer's state, which AdamW updates in
place. On the card it makes the optimizer one a graph can replay
(`capturable`); `train_step` called directly keeps the optimizer it is
given. The gradients are the step's own, as they are inside the
reference's jit: every call drops them after the update (`.grad` is None
between calls), so in a graph they are temporaries of the owner's pool,
which its shapes share, and the step adds no pass over them.

At one batch shape, on the card:
- the first call is the eager step (a manifest of mixed lengths gives
  many shapes that never come back, and those cost no capture);
- the second is the eager step again, run on the capture stream (the
  libraries make their handles and workspaces there, outside the pool),
  and then the capture, which runs nothing: so N calls are N steps of the
  eager trajectory;
- later calls copy the batch into the program's static inputs (numpy and
  host tensors through pinned staging), replay, add the capture's tally of
  K1 and K1's backward launches to their counters, and return clones of
  the static metrics on the card.
A capture that fails raises after its call's eager step has updated the
tree and the optimizer, and the error says so. Nothing runs in its place:
the shape's next call tries the capture again, and there is no switch
that turns capture off. A caller who wants the eager step calls
`train_step` itself.

A restore (`runtime/train_ckpt.py::restore_train_state`) copies the
parameters in place and gives the optimizer new state tensors
(`load_state_dict`). The step sees the new state at its next call and
drops its programs, which are then made again; until then it keeps the
state they bind, so a replay never writes to freed memory.

Features stay outside the graph, as the reference's `_batch` computes them
outside its jit. A tensor the caller keeps that autograd derived from a
leaf (a `clone()` under grad mode) keeps the leaf's gradient accumulator
on the caller's stream, and a capture on the side stream then fails: take
such copies with `detach()`.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Hashable, Sequence, Tuple

import numpy as np
import torch

from ..models.convert import tree_map
from . import profiling
from .compile_lock import COMPILE_LOCK
from .graphs import _COUNTERS, Program, Programs, capture_graph

TrainStep = Callable[[Any, torch.optim.Optimizer, Dict[str, Any]],
                     Tuple[Any, torch.optim.Optimizer, Dict[str, torch.Tensor]]]


def capturable(opt: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """`opt`, in place, as an optimizer a CUDA graph can replay: every
    group `capturable` (AdamW's step counts on the card and its bias
    corrections by tensor ops, with no host sync), and the step counts it
    already has moved onto their parameters' card, where `load_state_dict`
    puts a capturable optimizer's."""
    for group in opt.param_groups:
        group["capturable"] = True
    for p, state in opt.state.items():
        step = state.get("step")
        if isinstance(step, torch.Tensor) and step.device != p.device:
            state["step"] = step.to(device=p.device, dtype=torch.float32)
    return opt


class TrainProgram(Program):
    """One batch shape's step: `prog(*arrays)` → the step's metrics."""

    stepped = False     # the card has run this shape's first call

    def _capture(self) -> None:
        """`Program.__init__` on the card: the static inputs only; the
        graph is captured at the shape's second call."""
        dev = self.owner.device
        with torch.cuda.device(dev):
            self._static_in = [torch.zeros(s, dtype=dt, device=dev)
                               for s, dt in self.specs]
        self._staging = [None] * len(self.specs)

    def _step_and_capture(self, args: Sequence[Any]) -> Dict[str, Any]:
        owner = self.owner
        dev = owner.device
        with COMPILE_LOCK, owner.lock, torch.cuda.device(dev):
            self._fill(args)
            stepped = []

            def step():     # the warm-up is the eager step that counts
                out = self.fn(*self._static_in)
                stepped.append(time.perf_counter())
                return out
            try:
                graph, out, static_out, tally = capture_graph(
                    owner, step, lambda: self.fn(*self._static_in))
            except BaseException as err:
                if stepped:
                    err.add_note("the call's eager step ran before its "
                                 "capture failed: the parameters and the "
                                 "optimizer state have advanced one step")
                raise
            seconds = time.perf_counter() - stepped[0]
            current = torch.cuda.current_stream(dev)
            for v in out.values():      # made on the side stream, read on
                v.record_stream(current)    # the caller's
            self.graph, self._static_out, self.tally = graph, static_out, tally
        owner._count_capture(seconds)
        return out

    def _replay(self, args: Sequence[Any]) -> Dict[str, Any]:
        owner = self.owner
        with profiling.annotate("program.lock_wait"):
            owner.lock.acquire()
        try:
            with torch.cuda.device(owner.device):
                with torch.no_grad():
                    self._fill(args)
                    with profiling.annotate("program.replay"):
                        self.graph.replay()
                    out = {k: v.clone() for k, v in self._static_out.items()}
                for name, n in self.tally.items():
                    _COUNTERS[name](n)
                self.replays += 1
                owner.replays += 1
        finally:
            owner.lock.release()
        return out

    def __call__(self, *args: Any) -> Dict[str, Any]:
        owner = self.owner
        if self.graph is not None:
            return self._replay(args)
        if self.stepped:        # the shape came back: capture it
            return self._step_and_capture(args)
        on_card = owner.on_card
        with owner.lock, (torch.cuda.device(owner.device) if on_card
                          else contextlib.nullcontext()):
            out = self.fn(*self._eager_inputs(args))
            if on_card:
                self.stepped = True
            else:
                self.replays += 1
                owner.replays += 1
        return out


def _as_input(a: Any) -> Any:
    """A batch array as a program input: tensors on a card as they are,
    host tensors as numpy (so they go through the pinned staging)."""
    if isinstance(a, torch.Tensor):
        return a.detach().numpy() if a.device.type == "cpu" else a
    return np.asarray(a)


def _dtype(a: Any) -> torch.dtype:
    return a.dtype if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.empty(0, a.dtype)).dtype


class CapturedStep:
    """`capture_train_step`'s step: `step(params, opt_state, batch)` →
    (params, opt_state, {"loss", "ce", "quantity"}), the metrics on the
    step's device."""

    def __init__(self, train_step: TrainStep, params: Any,
                 opt_state: torch.optim.Optimizer):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        leaves = []
        tree_map(leaves.append, params)
        self.programs = Programs(leaves[0].device, "train-step")
        if self.programs.on_card:
            capturable(opt_state)
        self.eager = 0      # first calls at a shape on the card
        # the optimizer state the programs bind, held until they are dropped
        self._bound = opt_state.state

    def stats(self) -> Dict[str, Any]:
        """The owner's `Programs.stats()` and "eager": the calls on the
        card that ran a shape's first step without a graph."""
        return dict(self.programs.stats(), eager=self.eager)

    def __call__(self, params: Any, opt_state: torch.optim.Optimizer,
                 batch: Dict[str, Any]):
        if params is not self.params or opt_state is not self.opt_state:
            raise ValueError("a captured step trains the tree and optimizer "
                             "it was made for (its graphs bind their "
                             "storages)")
        names = tuple(sorted(batch))
        args = [_as_input(batch[n]) for n in names]
        key: Hashable = tuple((n, tuple(a.shape), _dtype(a))
                              for n, a in zip(names, args))
        progs = self.programs
        if opt_state.state is not self._bound:
            # a restore gave the optimizer new state tensors; the programs
            # bind the old ones (and its groups may have come back plain)
            for k in list(progs):
                progs.pop(k)
            if progs.on_card:
                capturable(opt_state)
            self._bound = opt_state.state

        def build():
            def fn(*arrays):
                out = self.train_step(self.params, self.opt_state,
                                      dict(zip(names, arrays)))[2]
                self.opt_state.zero_grad(set_to_none=True)
                return out
            return fn, [(k[1], k[2]) for k in key]
        prog = progs.get(key, build, make=TrainProgram)
        first = progs.on_card and prog.graph is None and not prog.stepped
        metrics = prog(*args)
        self.eager += first
        return params, opt_state, metrics


def capture_train_step(train_step: TrainStep, params: Any,
                       opt_state: torch.optim.Optimizer) -> CapturedStep:
    """`train_step` (`parallel/trainstep.py::make_train_step`'s) as one
    program per batch shape on the card of the parameters, bound to
    `params` and `opt_state` (as the reference's `jax.jit(train_step,
    donate_argnums=(0, 1))`)."""
    return CapturedStep(train_step, params, opt_state)
