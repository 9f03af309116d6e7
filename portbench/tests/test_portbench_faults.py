"""Each cell's check catches the faults its timed path can have: a run is
driven on the CPU at tiny geometry (the harness's look for a card skipped)
with the program broken underneath, and `correct` comes out false. Sound
runs of the same cells come out true."""
import dataclasses
import time

import pytest
import torch

from conftest import SMALL, tiny_cell

from portbench import harness

SECONDS = {"offline-b8-mixed": 0.5, "stream-hub-knee80": 3.0,
           "finetune-b32-10s": 0.5}


def run(name):
    cell = tiny_cell(name, **SMALL[name])
    out = harness.run(cell, 3 * 2 ** 31 + 5, SECONDS[name], False, "cpu",
                      time.perf_counter(), time.perf_counter,
                      log=lambda s: None)
    return out


@pytest.mark.parametrize("name", list(SMALL))
def test_sound_runs_are_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]


def _token_altered_offline(monkeypatch):
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer
    forward = paraformer.forward

    def altered(*a, **k):
        out = forward(*a, **k)
        tokens = out["tokens"].clone()
        tokens[0, 0] = (tokens[0, 0] + 1) % out["logits"].shape[-1]
        return dict(out, tokens=tokens)
    monkeypatch.setattr(paraformer, "forward", altered)


def _half_batch_offline(monkeypatch):
    from toolbox_for_asr_and_tts_tpu_torch.asr import recognizer
    transcribe = recognizer.Recognizer.transcribe

    def half(self, wavs, hotwords=None):
        done = transcribe(self, wavs[: len(wavs) // 2], hotwords)
        empty = [recognizer.TranscribeResult("", [], [], [])] * \
            (len(wavs) - len(done))
        return done + empty
    monkeypatch.setattr(recognizer.Recognizer, "transcribe", half)


def _token_altered_stream(monkeypatch):
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online
    step = paraformer_online.fused_step

    def altered(*a, **k):
        state, emb, n, ids = step(*a, **k)
        return state, emb, n, ids + (n[:, None] > 0).int()
    monkeypatch.setattr(paraformer_online, "fused_step", altered)


def _state_unchanged_stream(monkeypatch):
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online
    step = paraformer_online.fused_step

    def stuck(params, state, *a, **k):
        _, emb, n, ids = step(params, state, *a, **k)
        return dict(state), emb, n, ids
    monkeypatch.setattr(paraformer_online, "fused_step", stuck)


def _partial_before_tick_stream(monkeypatch):
    """The hub queues the frame and returns the slot's text at once,
    without waiting for the tick that holds the frame."""
    import numpy as np
    from toolbox_for_asr_and_tts_tpu_torch.service import hub

    def early(self, slot, chunk, timeout=None):
        with self._lock:
            gen = self._gen.get(slot, 0)
            chunk = np.asarray(chunk, np.float32)
            waiters = []
            if slot in self._pending:
                prev, waiters, _ = self._pending[slot]
                chunk = np.concatenate([prev, chunk])
            self._pending[slot] = (chunk, waiters, gen)
        self._work.set()
        return self.partial_text(slot)
    monkeypatch.setattr(hub.ChunkedHub, "submit", early)


def _replay_changed_offline(monkeypatch):
    """A batch served again comes back otherwise: state carried over from
    one call into the next."""
    from toolbox_for_asr_and_tts_tpu_torch.asr import recognizer
    transcribe = recognizer.Recognizer.transcribe
    seen = set()

    def drift(self, wavs, hotwords=None):
        out = transcribe(self, wavs, hotwords)
        key = tuple(len(w) for w in wavs)
        if key in seen and out[0].token_ids:
            ids = list(out[0].token_ids)
            ids[-1] = (ids[-1] + 1) % 64
            out[0] = dataclasses.replace(out[0], token_ids=ids)
        seen.add(key)
        return out
    monkeypatch.setattr(recognizer.Recognizer, "transcribe", drift)


def _state_unchanged_train(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _half_batch_train(monkeypatch):
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep
    loss = trainstep.paraformer_loss

    def half(params, feats, feat_lens, targets, target_lens, cfg, *a):
        h = feats.shape[0] // 2
        return loss(params, feats[:h], feat_lens[:h], targets[:h],
                    target_lens[:h], cfg, *a)
    monkeypatch.setattr(trainstep, "paraformer_loss", half)


FAULTS = [
    ("offline-b8-mixed", _token_altered_offline),
    ("offline-b8-mixed", _half_batch_offline),
    ("stream-hub-knee80", _token_altered_stream),
    ("stream-hub-knee80", _state_unchanged_stream),
    ("stream-hub-knee80", _partial_before_tick_stream),
    ("offline-b8-mixed", _replay_changed_offline),
    ("finetune-b32-10s", _state_unchanged_train),
    ("finetune-b32-10s", _half_batch_train),
]


@pytest.mark.parametrize("name,plant", FAULTS,
                         ids=[f"{n}-{p.__name__.strip('_')}"
                              for n, p in FAULTS])
def test_a_broken_path_is_not_correct(name, plant, monkeypatch):
    plant(monkeypatch)
    out = run(name)
    assert not out["correct"], out["checks"]
