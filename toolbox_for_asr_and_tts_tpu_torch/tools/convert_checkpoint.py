"""Checkpoint conversion and its weight-level round-trip check.

    python -m toolbox_for_asr_and_tts_tpu_torch.tools.convert_checkpoint \
        --family paraformer --model-dir models/damo/speech_paraformer-large_… \
        [--diff] [--config-json overrides.json]

Copy of `toolbox_for_asr_and_tts_tpu/tools/convert_checkpoint.py` over the
port's templates and `runtime/checkpoints.py` rules. Converts a
ModelScope/FunASR `model.pt` into the port's `torch_params.npz` cache. With
`--diff` every mapped tensor is converted and inverted back, and the
largest round-trip error and the checkpoint's unmapped tensors are
reported. `--config-json` overrides fields of the family's config (for
example the checkpoint's own geometry, or `{"bicif": true}` for the spk
Paraformer).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

import numpy as np
import torch

logger = logging.getLogger("toolbox.convert")

FAMILIES = ("paraformer", "fsmn_vad", "sambert", "hifigan", "campplus",
            "punc", "kws")


def _apply_overrides(cfg, overrides):
    """Dataclass config + {field: value} overrides (e.g. from the real
    checkpoint's config.json via --config-json)."""
    if not overrides:
        return cfg
    known = {f.name for f in dataclasses.fields(cfg)}
    unknown = sorted(set(overrides) - known)
    if unknown:
        raise SystemExit(f"unknown config fields {unknown}; "
                         f"valid: {sorted(known)}")
    fixed = {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
             if isinstance(v, list) else v
             for k, v in overrides.items()}
    return dataclasses.replace(cfg, **fixed)


def _family_setup(family: str, overrides=None):
    """(template, rules, convert kwargs) per model family. The template is a
    CPU draw of seed 0: `--diff` converts leniently, keeping template
    values where the checkpoint lacks a tensor."""
    from ..runtime import checkpoints as ckpt
    g = torch.Generator().manual_seed(0)
    if family == "paraformer":
        from ..models import paraformer
        cfg = _apply_overrides(paraformer.ParaformerConfig(), overrides)
        # --config-json '{"bicif": true}' selects the spk model's
        # BiCifParaformer variant (timestamp predictor tensors included)
        rules = ckpt.paraformer_rules(cfg.encoder_layers, cfg.decoder_layers,
                                      bicif=cfg.bicif)
        return paraformer.init_params(cfg, g), rules, {}
    if family == "fsmn_vad":
        from ..models import fsmn_vad
        cfg = _apply_overrides(fsmn_vad.FsmnVadConfig(), overrides)
        return (fsmn_vad.init_params(cfg, g),
                ckpt.fsmn_vad_rules(cfg.fsmn_layers), {})
    if family == "sambert":
        from ..models import sambert
        cfg = _apply_overrides(sambert.SambertConfig(), overrides)
        rules = ckpt.sambert_rules(cfg.encoder_layers, cfg.pnca_layers,
                                   cfg.postnet_layers)
        # the NAR fast-mode decoder is framework-only → keeps its draw; the
        # real postnet's BatchNorm folds to the channel affine
        return sambert.init_params(g, cfg), rules, {
            "keep_missing": True, "pre_transform": ckpt.fold_batch_norm}
    if family == "hifigan":
        from ..models import hifigan
        cfg = _apply_overrides(hifigan.HifiGanConfig(), overrides)
        rules = ckpt.hifigan_rules(len(cfg.upsample_rates),
                                   len(cfg.resblock_kernels),
                                   len(cfg.resblock_dilations[0]))
        return hifigan.init_params(g, cfg), rules, {
            "pre_transform": ckpt.fold_weight_norm}
    if family == "campplus":
        from ..models import campplus
        cfg = _apply_overrides(campplus.CampPlusConfig(), overrides)
        return (campplus.init_params(cfg, g),
                ckpt.campplus_rules(cfg.block_layers), {})
    if family == "punc":
        from ..models import ct_transformer
        cfg = _apply_overrides(ct_transformer.CTTransformerConfig(), overrides)
        return (ct_transformer.init_params(cfg, g),
                ckpt.ct_transformer_rules(cfg.num_layers), {})
    if family == "kws":
        from ..models import kws_ctc
        cfg = _apply_overrides(kws_ctc.KwsConfig(), overrides)
        return (kws_ctc.init_params(cfg, g),
                ckpt.kws_rules(cfg.num_layers, cfg.rorder), {})
    raise SystemExit(f"unknown family {family}; choose from {FAMILIES}")


def convert(family: str, model_dir: str, overrides=None) -> str:
    from ..runtime import checkpoints as ckpt
    template, rules, kwargs = _family_setup(family, overrides)
    params = ckpt.convert_or_load_cached(model_dir, template, rules, **kwargs)
    out = os.path.join(model_dir, ckpt.CACHE_NAME)
    if not os.path.exists(out):
        ckpt.save_converted(out, params)
    n = sum(a.size for a in ckpt.flatten_params(params).values())
    print(json.dumps({"family": family, "out": out, "n_params": int(n)}))
    return out


def diff(family: str, model_dir: str, overrides=None) -> None:
    """Weight-level diff: every mapped tensor must round-trip exactly."""
    from ..runtime import checkpoints as ckpt
    src = ckpt.find_checkpoint(model_dir)
    if src is None:
        raise SystemExit(f"no checkpoint under {model_dir}")
    sd = ckpt.load_torch_state_dict(src)
    template, rules, kwargs = _family_setup(family, overrides)
    if kwargs.get("pre_transform") is not None:
        sd = kwargs["pre_transform"](sd)
    params = ckpt.convert_state_dict(sd, rules, template, strict=False,
                                     keep_missing=True)
    back = ckpt.invert_to_state_dict(params, rules)
    worst = 0.0
    for name, arr in back.items():
        if name in sd:
            err = float(np.abs(np.asarray(sd[name], np.float32) - arr).max())
            worst = max(worst, err)
            if err > 1e-6:
                print(f"MISMATCH {name}: {err:.3e}")
    unmapped = sorted(k for k in set(sd) - set(back)
                      if not k.endswith("num_batches_tracked"))
    print(json.dumps({"worst_roundtrip_err": worst,
                      "unmapped_torch_tensors": unmapped[:20],
                      "n_unmapped": len(unmapped)}))


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", required=True, choices=FAMILIES)
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--diff", action="store_true")
    ap.add_argument("--config-json", default=None,
                    help="JSON file (or the checkpoint's config.json subset) "
                         "overriding the family config's dataclass fields")
    args = ap.parse_args()
    overrides = None
    if args.config_json:
        with open(args.config_json, encoding="utf-8") as f:
            overrides = json.load(f)
    convert(args.family, args.model_dir, overrides)
    if args.diff:
        diff(args.family, args.model_dir, overrides)


if __name__ == "__main__":
    main()
