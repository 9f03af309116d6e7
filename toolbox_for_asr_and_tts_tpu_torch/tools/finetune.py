"""Fine-tune the Paraformer on (wav, text) pairs, with checkpoint/resume.

    python -m toolbox_for_asr_and_tts_tpu_torch.tools.finetune \
        --manifest data.jsonl --model-dir models/damo/… \
        --ckpt-dir runs/ft1 --steps 1000 [--batch 8] [--save-every 100] \
        [--device cuda]

Port of `toolbox_for_asr_and_tts_tpu/tools/finetune.py`, flag for flag,
plus `--device` (the card unless "cpu" is given). `--manifest` is JSONL
{"wav": path, "text": str}; omit it to run a synthetic smoke batch. Resume is
automatic from the newest complete step under --ckpt-dir; `--export` writes
the final params as the port's serving `torch_params.npz`. Features are
fbank → LFR without CMVN, as the reference computes them here, one K2 launch
per batch on the card, outside the step. The step (`parallel/trainstep.py`)
runs as the reference's `jax.jit(train_step, donate_argnums=(0, 1))` does:
wrapped after the restore by `runtime/train_graph.py::capture_train_step`,
one CUDA graph per batch shape on the card, the eager step on the CPU. A
batch is padded to the longest row drawn, so a manifest of mixed lengths
gives one program per distinct frame count T, as the reference compiles
once per shape; the synthetic batch has one shape. A shape's first step
runs eagerly and its second is captured, so a T drawn once costs no
capture; later steps at that T replay.
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger("toolbox.finetune")


def _load_manifest(path, tokenizer, fe_cfg, k_max: int, t_cap_s: float
                   ) -> List[Tuple[np.ndarray, List[int]]]:
    from ..utils.audio import ensure_mono_16k, read_wav
    items = []
    with open(path, encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            row = json.loads(ln)
            x, sr = read_wav(row["wav"])
            wav = ensure_mono_16k(x, sr, fe_cfg.sample_rate)
            wav = wav[: int(t_cap_s * fe_cfg.sample_rate)]
            ids = [tokenizer.token_to_id[t] for t in row["text"]
                   if t in tokenizer.token_to_id][:k_max]
            if len(wav) and ids:
                items.append((wav, ids))
    if not items:
        raise SystemExit(f"no usable rows in {path}")
    logger.info("manifest: %d utterances", len(items))
    return items


def _features(sel: Sequence[Tuple[np.ndarray, List[int]]], fe_cfg,
              k_max: int, device) -> Dict[str, torch.Tensor]:
    """Rows (wav, ids) padded to one (T, K) → the step's batch on `device`:
    fbank → LFR features (no CMVN, as the reference's fine-tuning feeds
    them), computed under no_grad."""
    from ..ops import frontend as fe
    batch = len(sel)
    n_max = max(len(w) for w, _ in sel)
    t_fb = fe.num_fbank_frames(n_max, fe_cfg)
    t_lfr = fe.num_lfr_frames(t_fb, fe_cfg.lfr_n)
    wavs = np.zeros((batch, n_max), np.float32)
    lens = np.zeros((batch,), np.int64)
    targets = np.zeros((batch, k_max), np.int64)
    tlens = np.zeros((batch,), np.int64)
    for i, (w, ids) in enumerate(sel):
        wavs[i, :len(w)] = w
        lens[i] = len(w)
        targets[i, :len(ids)] = ids
        tlens[i] = len(ids)
    with torch.no_grad():
        feats = fe.fbank(torch.from_numpy(wavs).to(device), fe_cfg,
                         t_frames=t_fb)
        feats = fe.apply_lfr(feats, fe_cfg.lfr_m, fe_cfg.lfr_n, t_out=t_lfr)
        feat_lens = fe.frontend_valid_frames(
            torch.from_numpy(lens).to(device), fe_cfg)
    return {"feats": feats, "feat_lens": feat_lens,
            "targets": torch.from_numpy(targets).to(device),
            "target_lens": torch.from_numpy(tlens).to(device)}


def _batch(items, batch, fe_cfg, k_max, rng, device):
    """A random batch of `items` (the reference's draw) → `_features`."""
    return _features(_draw(items, batch, rng), fe_cfg, k_max, device)


def _draw(items, batch, rng):
    """The rows of one batch: `batch` of `items`, drawn with replacement."""
    return [items[i] for i in rng.integers(0, len(items), batch)]


def main(argv=None) -> Dict[str, Any]:
    """Run the CLI. Returns the tuned parameters, the config, the losses
    and the step's program stats (`CapturedStep.stats`: eager first steps,
    captures, replays), for callers that drive it in-process."""
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--model-dir", default=None,
                    help="start from a checkpoint dir (else random init)")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--k-max", type=int, default=32)
    ap.add_argument("--max-secs", type=float, default=20.0)
    ap.add_argument("--export", default=None,
                    help="write final params as a serving torch_params.npz")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model (smoke tests)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..asr.recognizer import Recognizer
    from ..device import resolve_device
    from ..models import paraformer
    from ..parallel.trainstep import adamw, make_train_step
    from ..runtime import train_ckpt as tc
    from ..runtime.train_graph import capture_train_step

    dev = resolve_device(args.device)
    if args.model_dir:
        reco = Recognizer.from_model_dir(args.model_dir, device=dev,
                                         use_mesh=False)
    else:
        cfg = (paraformer.ParaformerConfig(
            d_model=32, n_heads=2, ffn_dim=64, encoder_layers=2,
            decoder_layers=1, vocab_size=64) if args.tiny
            else paraformer.ParaformerConfig())
        reco = Recognizer.random(cfg=cfg, device=dev, use_mesh=False)
    cfg, params, tokenizer = reco.cfg, reco.params, reco.tokenizer
    fe_cfg = cfg.frontend

    init_opt, train_step = make_train_step(cfg, optimizer=adamw(args.lr),
                                           device=dev)
    opt_state = init_opt(params)
    start = 0
    restored = tc.restore_train_state(args.ckpt_dir, params, opt_state,
                                      device=dev)
    if restored is not None:
        start, params, opt_state = restored
        logger.info("resuming from step %d", start)
    step_fn = capture_train_step(train_step, params, opt_state)

    rng = np.random.default_rng(0)
    if args.manifest:
        items = _load_manifest(args.manifest, tokenizer, fe_cfg,
                               args.k_max, args.max_secs)
    else:
        logger.warning("no --manifest: SYNTHETIC smoke data")
        items = [(0.1 * rng.standard_normal(fe_cfg.sample_rate).astype(
            np.float32), list(range(3, 10))) for _ in range(8)]

    losses = []
    for step in range(start, args.steps):
        batch = _batch(items, args.batch, fe_cfg, args.k_max, rng, dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if not np.isfinite(loss):
            raise SystemExit(f"non-finite loss at step {step}")
        if step % 10 == 0 or step == args.steps - 1:
            logger.info("step %d loss %.4f (%.0f ms)", step, loss,
                        (time.perf_counter() - t0) * 1000)
        if (step + 1) % args.save_every == 0 or step == args.steps - 1:
            tc.save_train_state(args.ckpt_dir, step + 1, params, opt_state)
    if args.export:
        tc.export_params_npz(params, args.export)
        logger.info("exported serving params to %s", args.export)
    return {"params": params, "cfg": cfg, "tokenizer": tokenizer,
            "start": start, "losses": losses,
            "train_graphs": step_fn.stats()}


if __name__ == "__main__":
    main()
