"""Fine-tuning: the captured training step on batches of one shape.

The step is the port's `parallel/trainstep.py::make_train_step` (the
Paraformer loss, autograd, the port's AdamW) wrapped by
`runtime/train_graph.py::capture_train_step`, as `tools/finetune.py` runs
it: a shape's first call is eager, its second captures, later calls
replay. Set-up builds that one step object and drives it through its first
three steps (eager, capture, first replay) on rows that all differ; the
window goes on with the same object.

Traffic parameters ("params"):
- batch, frames (LFR frames per row, all valid), k_max (target slots),
  target_len [low, high]: the batch's shape and target lengths;
- seconds_per_row: the audio a row stands for;
- lr: the optimizer's learning rate (the reference takes `adamw` too).

Every batch is drawn on the device from the seed: features N(0, 1) (the
range CMVN gives), targets uniform over the non-special ids.

End-to-end: `audio_throughput.train`, seconds of audio stepped through the
optimizer over the window's wall time (each step ends in its loss read
back, as a training loop logs it).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from portbench import weights  # noqa: E402
from portbench.reference import paraformer as ref  # noqa: E402

CHECKED_STEPS = 3


class Batches:
    """The run's batches, in order, from one generator on the device."""

    def __init__(self, p: Dict, m: Dict, seed: int, device):
        self.p, self.m, self.device = p, m, device
        self.g = weights.generator(seed, device, weights.BATCHES)

    def next(self) -> Dict[str, torch.Tensor]:
        p, g, dev = self.p, self.g, self.device
        b, t, k = p["batch"], p["frames"], p["k_max"]
        lo, hi = p["target_len"]
        feats = torch.randn((b, t, self.m["input_dim"]), generator=g,
                            device=dev)
        targets = torch.randint(4, self.m["vocab_size"] - 1, (b, k),
                                generator=g, device=dev, dtype=torch.int32)
        lens = torch.randint(lo, hi + 1, (b,), generator=g, device=dev,
                             dtype=torch.int32)
        targets = targets * (torch.arange(k, device=dev)[None] < lens[:, None])
        return {"feats": feats,
                "feat_lens": torch.full((b,), t, dtype=torch.int32, device=dev),
                "targets": targets, "target_lens": lens}


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.m = config["model"]
        self.p = traffic["params"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.attempted = self.failed = 0

    def setup(self, seconds: float) -> None:
        from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import \
            ParaformerConfig
        from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep
        from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import \
            capture_train_step
        t = time.perf_counter()
        cfg = ParaformerConfig(**self.m)
        self.params = weights.make_params(self.m, self.seed, self.device)
        self.phases = {"weights": time.perf_counter() - t}
        init_opt, train_step = trainstep.make_train_step(
            cfg, trainstep.adamw(self.p["lr"]), device=self.device)
        self.opt = init_opt(self.params)
        self.step = capture_train_step(train_step, self.params, self.opt)
        self.batches = Batches(self.p, self.m, self.seed, self.device)
        leaves = weights.leaves_of(self.params)
        self.losses: List[float] = []
        for i in range(CHECKED_STEPS):
            t = time.perf_counter()
            _, _, out = self.step(self.params, self.opt, self.batches.next())
            self.losses.append(float(out["loss"]))
            self.phases[f"step {i + 1}"] = time.perf_counter() - t
            if i == 0:
                # the first gradient, as AdamW holds it: m1 = (1 − β1)·g1
                # (none where the step left the optimizer without state)
                b1 = self.opt.param_groups[0]["betas"][0]
                self.grad1 = {k: (self.opt.state[v].get(
                    "exp_avg", torch.zeros_like(v)) / (1 - b1))
                    .detach().clone() for k, v in leaves}
        self.after = {k: v.detach().clone() for k, v in leaves}
        self._captures0 = self._captures()

    def _captures(self) -> int:
        from toolbox_for_asr_and_tts_tpu_torch.runtime import graphs
        return sum(o["captures"] for o in graphs.report())

    def window(self, seconds: float, tracer) -> None:
        p = self.p
        self.calls: List[Dict] = []
        t0 = time.perf_counter()
        end = t0 + seconds
        trace_at = t0 + min(p["trace"]["after_s"], 0.25 * seconds)
        while time.perf_counter() < end:
            if time.perf_counter() >= trace_at:
                tracer.begin(p["trace"]["seconds"])
            tracer.poll()
            traced_now = tracer.recording
            batch = self.batches.next()
            with tracer.span("train_step"):
                _, _, out = self.step(self.params, self.opt, batch)
                float(out["loss"])
            self.attempted += 1
            self.calls.append({
                "kind": "train_step", "traced": traced_now,
                "batch": p["batch"], "frames": p["frames"],
                "k_max": p["k_max"],
                "tokens": int(batch["target_lens"].sum())})
        tracer.stop()
        self.window_s = time.perf_counter() - t0 - tracer.overhead_s
        self.captures_window = self._captures() - self._captures0

    def end_to_end(self) -> Dict[str, float]:
        p = self.p
        return {"audio_throughput.train": len(self.calls) * p["batch"]
                * p["seconds_per_row"] / self.window_s}

    def context(self) -> Dict:
        """The window's record: each step with its shapes and tokens, and
        whether the trace saw it."""
        return {"window_s": self.window_s, "calls": self.calls,
                "captures_window": self.captures_window}

    def free(self) -> None:
        del self.step, self.opt, self.params

    def check(self) -> Dict[str, float]:
        """The reference's first three steps from the same weights and
        batches, drawn again from the seed, against the program's."""
        from portbench.check import judge_training
        want, before = self.reference()
        prog = {"losses": self.losses, "grad": self.grad1,
                "change": {k: self.after[k] - before[k] for k in before}}
        return judge_training(prog, want)

    def reference(self, rows: int = None):
        """Three steps of the reference (plain autograd, AdamW by its
        formula) from the seed's weights and batches, on the first `rows`
        rows of each batch (all by default) → ({"losses", "grad" (the first
        gradient), "change" (after step 3)}, the weights before step 1)."""
        params = weights.make_params(self.m, self.seed, self.device)
        leaves = weights.leaves_of(params)
        before = {k: v.detach().clone() for k, v in leaves}
        ts = [v.requires_grad_(True) for _, v in leaves]
        mom = [torch.zeros_like(v) for v in ts]
        vel = [torch.zeros_like(v) for v in ts]
        batches = Batches(self.p, self.m, self.seed, self.device)
        losses, grad1 = [], None
        for step in range(1, CHECKED_STEPS + 1):
            b = {k: v[:rows] for k, v in batches.next().items()}
            loss = ref.train_loss(params, b["feats"], b["feat_lens"],
                                  b["targets"], b["target_lens"], self.m)
            grads = torch.autograd.grad(loss, ts)
            losses.append(float(loss.detach()))
            if step == 1:
                grad1 = {k: g.detach().clone()
                         for (k, _), g in zip(leaves, grads)}
            ref.adamw_step(ts, grads, mom, vel, step, lr=self.p["lr"],
                           **self.traffic["optimizer"])
            del grads, loss
        change = {k: v.detach() - before[k] for k, v in leaves}
        return {"losses": losses, "grad": grad1, "change": change}, before

    def control(self, mode: str) -> Dict[str, float]:
        """The reference in the program's place, computed with TF32 on
        ("tf32"), or on half of each batch, the loss's mean taken over the
        rest ("half_batch"), judged against the reference."""
        from portbench.check import judge_training
        from portbench.precision import tf32
        want, _ = self.reference()
        with tf32(mode == "tf32"):
            got, _ = self.reference(self.p["batch"] // 2
                                    if mode == "half_batch" else None)
        return judge_training(got, want)
