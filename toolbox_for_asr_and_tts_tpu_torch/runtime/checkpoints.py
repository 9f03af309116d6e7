"""Checkpoint conversion: ModelScope/FunASR/KAN-TTS torch state dicts → the
port's parameter trees, with an on-disk cache.

Copy of `toolbox_for_asr_and_tts_tpu/runtime/checkpoints.py` for the port:

    resolve model dir → parse config/cmvn/vocab → map `model.pt` state-dict
    names onto the family's parameter tree → save the converted `.npz` next
    to the source, so conversion happens once.

The name maps (one rule table per family) and the BatchNorm and weight-norm
folds are the reference's, unchanged. The converted tree holds numpy arrays;
the loaders move it to the card with `models/convert.py::params_from_numpy`.
`invert_to_state_dict` builds a synthetic torch-style state dict from a
tree, which the tests use to round-trip the maps without real weights.

Against the reference:
- templates are the port's own trees; `shape_template` builds one on the
  meta device (shapes only, no memory), which is all a strict conversion
  reads;
- a config file that exists but does not parse raises (the reference logs
  it and falls back to default geometry); a `config.yaml` needs PyYAML;
- the caches are the port's own, `torch_params.npz` (and `<ckpt>.torch.npz`
  for TTS): the reference's `jax_params.npz` is neither read nor written,
  so both packages can share a mounted directory.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("toolbox.checkpoints")

CACHE_NAME = "torch_params.npz"
CHECKPOINT_NAMES = ("model.pt", "model.pb", "pytorch_model.bin")


# ------------------------------------------------------------ model config
def load_model_config(model_dir: str) -> Dict[str, Any]:
    """Parse the checkpoint's own config (FunASR `config.yaml`, ModelScope
    `configuration.json`, or `config.json`) so model hyperparameters come
    from the mounted checkpoint instead of defaults.

    The first file that parses wins. A file that exists but does not parse
    (a `config.yaml` without PyYAML installed included) raises with its
    path, unless a later one parses. Returns {} when no config file exists
    (callers keep their defaults)."""
    failed: Optional[Tuple[str, Exception]] = None
    for name in ("config.yaml", "config.json", "configuration.json"):
        p = os.path.join(model_dir, name)
        if not os.path.exists(p):
            continue
        try:
            conf = _read_config(p)
        except (ImportError, ValueError) as e:
            failed = failed or (p, e)
            continue
        if isinstance(conf, dict):
            # ModelScope configuration.json nests the FunASR config under
            # "model" / "model_config"
            for key in ("model_config", "model"):
                if isinstance(conf.get(key), dict) and (
                        "encoder_conf" in conf[key] or "input_dim" in conf[key]):
                    return conf[key]
            return conf
    if failed is not None:
        path, err = failed
        raise ValueError(f"unparseable model config {path}: "
                         f"{type(err).__name__}: {err}") from err
    return {}


def _read_config(path: str) -> Any:
    """One config file's contents. Raises ImportError for a `.yaml` without
    PyYAML and ValueError for a file that does not parse."""
    with open(path, encoding="utf-8") as f:
        if not path.endswith(".yaml"):
            return json.load(f)   # JSONDecodeError is a ValueError
        import yaml
        try:
            return yaml.safe_load(f)
        except yaml.YAMLError as e:
            raise ValueError(str(e)) from e


def search_config(conf: Any, names: Tuple[str, ...], default: Any = None) -> Any:
    """Depth-first search a nested config for the first key in `names`.

    KAN-TTS / ModelScope configs nest model hyperparameters at varying depths
    (e.g. `Model: KanTtsSAMBERT: params: …`, `model: am: …`); alias tuples
    absorb the naming drift across package revisions. Keys at the current
    level win over deeper matches; dict-valued entries are treated as
    sub-configs, not leaves.
    """
    if isinstance(conf, dict):
        for n in names:
            if n in conf and not isinstance(conf[n], dict):
                return conf[n]
        for v in conf.values():
            found = search_config(v, names, default=_MISSING)
            if found is not _MISSING:
                return found
    return default


_MISSING = object()


# ------------------------------------------------------------------- kaldi
def parse_kaldi_cmvn(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a kaldi-nnet `am.mvn` file → (add_shift means, rescale istd).

    Format: `<AddShift> ... [ m1 m2 ... ]` then `<Rescale> ... [ s1 s2 ... ]`.
    The stored means are already negated (they are added), matching
    `ops.frontend.apply_cmvn`.
    """
    with open(path, encoding="utf-8") as f:
        text = f.read()
    vecs = re.findall(r"\[([^\]]*)\]", text)
    arrays = [np.array(v.split(), dtype=np.float32) for v in vecs]
    arrays = [a for a in arrays if a.size > 1]
    if len(arrays) < 2:
        raise ValueError(f"could not parse CMVN vectors from {path}")
    return arrays[0], arrays[1]


# ------------------------------------------------------------ templates
class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so the families'
    init functions (which allocate on `g.device`) draw nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def shape_template(init: Callable[[torch.Generator], Any]) -> Any:
    """A family's tree with every leaf on the meta device: the structure
    and shapes a strict conversion checks against, at no memory or time
    cost (the large CT-Transformer's embedding alone is 471067 × 256).
    `init` takes a generator, e.g. `lambda g: paraformer.init_params(cfg,
    g)`. Use a real template where `keep_missing` keeps template values."""
    with torch.device("meta"):
        return init(_MetaGenerator())


# ------------------------------------------------------- tree <-> flat
def _to_numpy(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_params(v, f"{prefix}{i}."))
    elif tree is None:
        pass  # structural None (e.g. identity shortcut / absent transit)
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def unflatten_like(template: Any, flat: Dict[str, np.ndarray], prefix: str = "",
                   keep_missing: bool = False) -> Any:
    """Rebuild a tree shaped like `template` from flat {path: array}.

    Only the template's structure and leaf shapes are read, except that
    keep_missing=True keeps the template's own value for paths absent from
    `flat` — used for framework-only parameters that real checkpoints don't
    have (e.g. Sambert's NAR fast-mode decoder next to the converted PNCA
    weights)."""
    if isinstance(template, dict):
        return {k: unflatten_like(v, flat, f"{prefix}{k}.", keep_missing)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [unflatten_like(v, flat, f"{prefix}{i}.", keep_missing)
                for i, v in enumerate(template)]
    if template is None:
        return None  # structural None stays None
    key = prefix[:-1]
    if key not in flat:
        if keep_missing:
            return template
        raise KeyError(f"missing parameter {key}")
    got, want = tuple(flat[key].shape), tuple(template.shape)
    if got != want:
        raise ValueError(f"shape mismatch for {key}: checkpoint {got} vs model {want}")
    return flat[key]


def save_converted(path: str, params: Any) -> None:
    np.savez(path, **flatten_params(params))


def _leaf_paths(tree: Any, prefix: str = "") -> List[str]:
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}{i}.")]
    return [] if tree is None else [prefix[:-1]]


def load_converted(path: str, template: Any) -> Any:
    """A cache written by `save_converted` → tree shaped like `template`.
    A cache for another template (e.g. a plain Paraformer's, read with
    the BiCIF template) raises KeyError before any array is read."""
    with np.load(path) as z:
        names = set(z.files)
        missing = [p for p in _leaf_paths(template) if p not in names]
        if missing:
            raise KeyError(f"missing parameter {missing[0]} in {path}")
        return unflatten_like(template, z)


# ----------------------------------------------------------- name mapping
# A rule maps a flat tree path to (torch name, transform). Transforms:
#   "t"    — transpose 2-D linear weight (torch [out,in] → the tree's [in,out])
#   ""     — copy as-is (conv weights share torch's (O, I/g, K) layout;
#             norms/biases are 1-D)
Rule = Tuple[str, str]


def _enc_layer(src: str, dst: str) -> List[Rule]:
    return [
        (f"{dst}.norm1.g", f"{src}.norm1.weight"),
        (f"{dst}.norm1.b", f"{src}.norm1.bias"),
        (f"{dst}.attn.qkv.w", f"{src}.self_attn.linear_q_k_v.weight!t"),
        (f"{dst}.attn.qkv.b", f"{src}.self_attn.linear_q_k_v.bias"),
        (f"{dst}.attn.out.w", f"{src}.self_attn.linear_out.weight!t"),
        (f"{dst}.attn.out.b", f"{src}.self_attn.linear_out.bias"),
        (f"{dst}.attn.fsmn.w", f"{src}.self_attn.fsmn_block.weight"),
        (f"{dst}.norm2.g", f"{src}.norm2.weight"),
        (f"{dst}.norm2.b", f"{src}.norm2.bias"),
        (f"{dst}.ffn.w1.w", f"{src}.feed_forward.w_1.weight!t"),
        (f"{dst}.ffn.w1.b", f"{src}.feed_forward.w_1.bias"),
        (f"{dst}.ffn.w2.w", f"{src}.feed_forward.w_2.weight!t"),
        (f"{dst}.ffn.w2.b", f"{src}.feed_forward.w_2.bias"),
    ]


def bicif_rules() -> List[Rule]:
    """BiCifParaformer timestamp-predictor tensors (CifPredictorV3:
    upsample_cnn ConvTranspose1d + bidirectional LSTM + cif_output2) —
    present in `paraformer-large-vad-punc-spk` (the diarization/final-
    transcription model, voice_interface.py:776-841), absent from the plain
    vocab8404 offline/online checkpoints."""
    up = "predictor.upsample"
    return [
        (f"{up}.cnn.w", "predictor.upsample_cnn.weight"),   # [in, out, k]
        (f"{up}.cnn.b", "predictor.upsample_cnn.bias"),
        (f"{up}.fwd.w_ih", "predictor.blstm.weight_ih_l0"),
        (f"{up}.fwd.w_hh", "predictor.blstm.weight_hh_l0"),
        (f"{up}.fwd.b_ih", "predictor.blstm.bias_ih_l0"),
        (f"{up}.fwd.b_hh", "predictor.blstm.bias_hh_l0"),
        (f"{up}.bwd.w_ih", "predictor.blstm.weight_ih_l0_reverse"),
        (f"{up}.bwd.w_hh", "predictor.blstm.weight_hh_l0_reverse"),
        (f"{up}.bwd.b_ih", "predictor.blstm.bias_ih_l0_reverse"),
        (f"{up}.bwd.b_hh", "predictor.blstm.bias_hh_l0_reverse"),
        (f"{up}.out.w", "predictor.cif_output2.weight!t"),
        (f"{up}.out.b", "predictor.cif_output2.bias"),
    ]


def paraformer_rules(n_enc: int, n_dec: int,
                     bicif: bool = False) -> List[Rule]:
    """FunASR Paraformer state_dict ↔ models/paraformer.py pytree."""
    rules: List[Rule] = []
    if bicif:
        rules += bicif_rules()
    rules += _enc_layer("encoder.encoders0.0", "encoder.layers.0")
    for i in range(1, n_enc):
        rules += _enc_layer(f"encoder.encoders.{i-1}", f"encoder.layers.{i}")
    rules += [
        ("encoder.after_norm.g", "encoder.after_norm.weight"),
        ("encoder.after_norm.b", "encoder.after_norm.bias"),
        ("predictor.conv.w", "predictor.cif_conv1d.weight"),
        ("predictor.conv.b", "predictor.cif_conv1d.bias"),
        ("predictor.out.w", "predictor.cif_output.weight!t"),
        ("predictor.out.b", "predictor.cif_output.bias"),
    ]
    for i in range(n_dec):
        s, d = f"decoder.decoders.{i}", f"decoder.layers.{i}"
        rules += [
            (f"{d}.norm1.g", f"{s}.norm1.weight"),
            (f"{d}.norm1.b", f"{s}.norm1.bias"),
            # decoder FFN = PositionwiseFeedForwardDecoderSANM: inner
            # LayerNorm over the hidden dim, w_2 has bias=False upstream
            (f"{d}.ffn.w1.w", f"{s}.feed_forward.w_1.weight!t"),
            (f"{d}.ffn.w1.b", f"{s}.feed_forward.w_1.bias"),
            (f"{d}.ffn.norm.g", f"{s}.feed_forward.norm.weight"),
            (f"{d}.ffn.norm.b", f"{s}.feed_forward.norm.bias"),
            (f"{d}.ffn.w2.w", f"{s}.feed_forward.w_2.weight!t"),
            (f"{d}.norm2.g", f"{s}.norm2.weight"),
            (f"{d}.norm2.b", f"{s}.norm2.bias"),
            (f"{d}.fsmn.w", f"{s}.self_attn.fsmn_block.weight"),
            (f"{d}.norm3.g", f"{s}.norm3.weight"),
            (f"{d}.norm3.b", f"{s}.norm3.bias"),
            (f"{d}.src_attn.q.w", f"{s}.src_attn.linear_q.weight!t"),
            (f"{d}.src_attn.q.b", f"{s}.src_attn.linear_q.bias"),
            (f"{d}.src_attn.kv.w", f"{s}.src_attn.linear_k_v.weight!t"),
            (f"{d}.src_attn.kv.b", f"{s}.src_attn.linear_k_v.bias"),
            (f"{d}.src_attn.out.w", f"{s}.src_attn.linear_out.weight!t"),
            (f"{d}.src_attn.out.b", f"{s}.src_attn.linear_out.bias"),
        ]
    rules += [
        ("decoder.final.norm1.g", "decoder.decoders3.0.norm1.weight"),
        ("decoder.final.norm1.b", "decoder.decoders3.0.norm1.bias"),
        ("decoder.final.ffn.w1.w", "decoder.decoders3.0.feed_forward.w_1.weight!t"),
        ("decoder.final.ffn.w1.b", "decoder.decoders3.0.feed_forward.w_1.bias"),
        ("decoder.final.ffn.norm.g", "decoder.decoders3.0.feed_forward.norm.weight"),
        ("decoder.final.ffn.norm.b", "decoder.decoders3.0.feed_forward.norm.bias"),
        ("decoder.final.ffn.w2.w", "decoder.decoders3.0.feed_forward.w_2.weight!t"),
        ("decoder.after_norm.g", "decoder.after_norm.weight"),
        ("decoder.after_norm.b", "decoder.after_norm.bias"),
        ("decoder.out.w", "decoder.output_layer.weight!t"),
        ("decoder.out.b", "decoder.output_layer.bias"),
    ]
    return rules


def fsmn_vad_rules(n_layers: int = 4) -> List[Rule]:
    """FunASR FSMN-VAD encoder state_dict ↔ models/fsmn_vad.py pytree.

    FunASR names (funasr FSMN): encoder.in_linear1/in_linear2 (AffineTransform
    .linear.{weight,bias}), encoder.fsmn.{i}.0 LinearTransform, .1 FSMNBlock
    (conv_left weight [d,1,l,1] as Conv2d), .2 AffineTransform, out_linear1/2.
    """
    rules: List[Rule] = [
        ("in1.w", "encoder.in_linear1.linear.weight!t"),
        ("in1.b", "encoder.in_linear1.linear.bias"),
        ("in2.w", "encoder.in_linear2.linear.weight!t"),
        ("in2.b", "encoder.in_linear2.linear.bias"),
        ("out1.w", "encoder.out_linear1.linear.weight!t"),
        ("out1.b", "encoder.out_linear1.linear.bias"),
        ("out2.w", "encoder.out_linear2.linear.weight!t"),
        ("out2.b", "encoder.out_linear2.linear.bias"),
    ]
    for i in range(n_layers):
        rules += [
            (f"blocks.{i}.proj.w", f"encoder.fsmn.{i}.0.linear.weight!t"),
            (f"blocks.{i}.fsmn.w", f"encoder.fsmn.{i}.1.conv_left.weight!squeeze"),
            (f"blocks.{i}.affine.w", f"encoder.fsmn.{i}.2.linear.weight!t"),
            (f"blocks.{i}.affine.b", f"encoder.fsmn.{i}.2.linear.bias"),
        ]
    return rules


def sambert_rules(n_enc: int, n_pnca: int, n_postnet: int) -> List[Rule]:
    """KAN-TTS Sambert state_dict ↔ models/sambert.py pytree (PNCA decoder).

    Torch names follow the public KAN-TTS module layout: 4-stream linguistic
    embeddings (`text_encoder.{sy,tone,syllable_flag,word_segment}_emb`),
    FFT encoder stack, `spk_tokenizer`/`emo_tokenizer`, dur/pitch/energy
    predictors, `mel_decoder` PNCA layers with dual X/H attention, and the
    BatchNorm `mel_postnet` (folded to a channel affine at conversion).
    The full tree is locked by a hand-built torch KanTtsSAMBERT carrying
    these names (tests/ref_kantts_sambert.py +
    tests/test_tts_convert_parity.py::test_sambert_full_model_torch_parity —
    converted mel == torch mel, zero unmapped tensors, like the other six
    families). Residual risk is naming drift in the real package, which
    `tools/convert_checkpoint --family sambert --diff` reports tensor by
    tensor at mount time.

    The NAR fast-mode decoder (`decoder`, `mel_out`) is framework-only and
    intentionally unmapped — convert with keep_missing=True.
    """
    rules: List[Rule] = [
        # 4-stream linguistic unit (kantts lfeat_type_list: sy, tone,
        # syllable_flag, word_segment) + speaker/emotion token tables
        ("ling.sy.table", "text_encoder.sy_emb.weight"),
        ("ling.tone.table", "text_encoder.tone_emb.weight"),
        ("ling.syllable_flag.table", "text_encoder.syllable_flag_emb.weight"),
        ("ling.word_segment.table", "text_encoder.word_segment_emb.weight"),
        ("spk.table", "spk_tokenizer.weight"),
        ("emo.table", "emo_tokenizer.weight"),
    ]
    for i in range(n_enc):
        s, d = f"text_encoder.layer_stack.{i}", f"encoder.{i}"
        rules += [
            (f"{d}.norm1.g", f"{s}.slf_attn.layer_norm.weight"),
            (f"{d}.norm1.b", f"{s}.slf_attn.layer_norm.bias"),
            (f"{d}.attn.q.w", f"{s}.slf_attn.w_qs.weight!t"),
            (f"{d}.attn.q.b", f"{s}.slf_attn.w_qs.bias"),
            (f"{d}.attn.k.w", f"{s}.slf_attn.w_ks.weight!t"),
            (f"{d}.attn.k.b", f"{s}.slf_attn.w_ks.bias"),
            (f"{d}.attn.v.w", f"{s}.slf_attn.w_vs.weight!t"),
            (f"{d}.attn.v.b", f"{s}.slf_attn.w_vs.bias"),
            (f"{d}.attn.out.w", f"{s}.slf_attn.fc.weight!t"),
            (f"{d}.attn.out.b", f"{s}.slf_attn.fc.bias"),
            (f"{d}.norm2.g", f"{s}.pos_ffn.layer_norm.weight"),
            (f"{d}.norm2.b", f"{s}.pos_ffn.layer_norm.bias"),
            (f"{d}.ffn.w1.w", f"{s}.pos_ffn.w_1.weight!t"),
            (f"{d}.ffn.w1.b", f"{s}.pos_ffn.w_1.bias"),
            (f"{d}.ffn.w2.w", f"{s}.pos_ffn.w_2.weight!t"),
            (f"{d}.ffn.w2.b", f"{s}.pos_ffn.w_2.bias"),
        ]
    for name in ("duration", "pitch", "energy"):
        s = {"duration": "dur_predictor", "pitch": "pitch_predictor",
             "energy": "energy_predictor"}[name]
        rules += [
            (f"{name}.c1.w", f"{s}.conv1.weight"),
            (f"{name}.c1.b", f"{s}.conv1.bias"),
            (f"{name}.ln1.g", f"{s}.ln1.weight"),
            (f"{name}.ln1.b", f"{s}.ln1.bias"),
            (f"{name}.c2.w", f"{s}.conv2.weight"),
            (f"{name}.c2.b", f"{s}.conv2.bias"),
            (f"{name}.ln2.g", f"{s}.ln2.weight"),
            (f"{name}.ln2.b", f"{s}.ln2.bias"),
            (f"{name}.out.w", f"{s}.linear.weight!t"),
            (f"{name}.out.b", f"{s}.linear.bias"),
        ]
    rules += [
        ("pitch_embed.w", "pitch_embedding.conv.weight"),
        ("pitch_embed.b", "pitch_embedding.conv.bias"),
        ("energy_embed.w", "energy_embedding.conv.weight"),
        ("energy_embed.b", "energy_embedding.conv.bias"),
    ]
    for i in range(n_pnca):
        s, d = f"mel_decoder.layer_stack.{i}", f"pnca.layers.{i}"
        rules += [
            (f"{d}.q.w", f"{s}.pnca_attn.w_qs.weight!t"),
            (f"{d}.q.b", f"{s}.pnca_attn.w_qs.bias"),
            (f"{d}.kx.w", f"{s}.pnca_attn.w_ks_x.weight!t"),
            (f"{d}.kx.b", f"{s}.pnca_attn.w_ks_x.bias"),
            (f"{d}.vx.w", f"{s}.pnca_attn.w_vs_x.weight!t"),
            (f"{d}.vx.b", f"{s}.pnca_attn.w_vs_x.bias"),
            (f"{d}.kh.w", f"{s}.pnca_attn.w_ks_h.weight!t"),
            (f"{d}.kh.b", f"{s}.pnca_attn.w_ks_h.bias"),
            (f"{d}.vh.w", f"{s}.pnca_attn.w_vs_h.weight!t"),
            (f"{d}.vh.b", f"{s}.pnca_attn.w_vs_h.bias"),
            (f"{d}.fc.w", f"{s}.pnca_attn.fc.weight!t"),
            (f"{d}.fc.b", f"{s}.pnca_attn.fc.bias"),
            (f"{d}.norm_attn.g", f"{s}.pnca_attn.layer_norm.weight"),
            (f"{d}.norm_attn.b", f"{s}.pnca_attn.layer_norm.bias"),
            (f"{d}.ffn.w1.w", f"{s}.pos_ffn.w_1.weight!t"),
            (f"{d}.ffn.w1.b", f"{s}.pos_ffn.w_1.bias"),
            (f"{d}.ffn.w2.w", f"{s}.pos_ffn.w_2.weight!t"),
            (f"{d}.ffn.w2.b", f"{s}.pos_ffn.w_2.bias"),
            (f"{d}.norm_ffn.g", f"{s}.pos_ffn.layer_norm.weight"),
            (f"{d}.norm_ffn.b", f"{s}.pos_ffn.layer_norm.bias"),
        ]
    rules += [
        ("pnca.prenet.fc1.w", "mel_decoder.prenet.fc1.weight!t"),
        ("pnca.prenet.fc1.b", "mel_decoder.prenet.fc1.bias"),
        ("pnca.prenet.fc2.w", "mel_decoder.prenet.fc2.weight!t"),
        ("pnca.prenet.fc2.b", "mel_decoder.prenet.fc2.bias"),
        ("pnca.prenet.proj.w", "mel_decoder.prenet.proj.weight!t"),
        ("pnca.prenet.proj.b", "mel_decoder.prenet.proj.bias"),
        ("pnca.mel_out.w", "mel_decoder.mel_out.weight!t"),
        ("pnca.mel_out.b", "mel_decoder.mel_out.bias"),
    ]
    for i in range(n_postnet):
        # norm.{weight,bias} are the BN affine AFTER fold_batch_norm folded
        # the running stats in (real KAN-TTS postnet is Conv1d+BatchNorm1d)
        rules += [
            (f"postnet.{i}.conv.w", f"mel_postnet.conv_stack.{i}.conv.weight"),
            (f"postnet.{i}.conv.b", f"mel_postnet.conv_stack.{i}.conv.bias"),
            (f"postnet.{i}.norm.g", f"mel_postnet.conv_stack.{i}.norm.weight"),
            (f"postnet.{i}.norm.b", f"mel_postnet.conv_stack.{i}.norm.bias"),
        ]
    return rules


def _bn_rules(dst: str, src: str) -> List[Rule]:
    return [(f"{dst}.g", f"{src}.weight"), (f"{dst}.b", f"{src}.bias"),
            (f"{dst}.mean", f"{src}.running_mean"),
            (f"{dst}.var", f"{src}.running_var")]


def campplus_rules(block_layers=(12, 24, 16)) -> List[Rule]:
    """speakerlab/3D-Speaker `CAMPPlus` state_dict ↔ models/campplus.py.

    Matches the module tree of the `iic/speech_campplus_sv_zh-cn_16k-common`
    checkpoint: head (FCM with conv shortcuts), xvector.tdnn,
    xvector.block{b}.tdnnd{i} (nonlinear1/linear1/nonlinear2/cam_layer),
    xvector.transit{b}, out_nonlinear, dense. 1×1 Conv1d weights map onto
    the tree's linears via the `c1x1` transform."""
    rules: List[Rule] = [
        ("fcm.conv1.w", "head.conv1.weight"),
        *_bn_rules("fcm.bn1", "head.bn1"),
        ("fcm.conv2.w", "head.conv2.weight"),
        *_bn_rules("fcm.bn2", "head.bn2"),
    ]
    for li, layer in enumerate(("layer1", "layer2"), start=1):
        for i in range(2):
            s = f"head.layer{li}.{i}"
            d = f"fcm.{layer}.{i}"
            rules += [(f"{d}.c1.w", f"{s}.conv1.weight"),
                      *_bn_rules(f"{d}.b1", f"{s}.bn1"),
                      (f"{d}.c2.w", f"{s}.conv2.weight"),
                      *_bn_rules(f"{d}.b2", f"{s}.bn2")]
            if i == 0:  # stride-2 block has the conv shortcut
                rules += [(f"{d}.sc.w", f"{s}.shortcut.0.weight"),
                          *_bn_rules(f"{d}.sbn", f"{s}.shortcut.1")]
    rules += [
        ("tdnn.w.w", "xvector.tdnn.linear.weight"),
        ("tdnn.w.b", "xvector.tdnn.linear.bias"),
        *_bn_rules("tdnn.bn", "xvector.tdnn.nonlinear.batchnorm"),
    ]
    for b, n_layers in enumerate(block_layers, start=1):
        for i in range(n_layers):
            s = f"xvector.block{b}.tdnnd{i + 1}"
            d = f"blocks.{b - 1}.layers.{i}"
            rules += [
                *_bn_rules(f"{d}.bn1", f"{s}.nonlinear1.batchnorm"),
                (f"{d}.lin.w", f"{s}.linear1.weight!c1x1"),
                *_bn_rules(f"{d}.bn2", f"{s}.nonlinear2.batchnorm"),
                (f"{d}.conv.w", f"{s}.cam_layer.linear_local.weight"),
                (f"{d}.cam1.w", f"{s}.cam_layer.linear1.weight!c1x1"),
                (f"{d}.cam1.b", f"{s}.cam_layer.linear1.bias"),
                (f"{d}.cam2.w", f"{s}.cam_layer.linear2.weight!c1x1"),
                (f"{d}.cam2.b", f"{s}.cam_layer.linear2.bias"),
            ]
        if b < len(block_layers):
            rules += [
                *_bn_rules(f"blocks.{b - 1}.transit.bn",
                           f"xvector.transit{b}.nonlinear.batchnorm"),
                (f"blocks.{b - 1}.transit.lin.w",
                 f"xvector.transit{b}.linear.weight!c1x1"),
            ]
    rules += [
        *_bn_rules("out_bn", "xvector.out_nonlinear.batchnorm"),
        ("embed.w", "xvector.dense.linear.weight!c1x1"),
        ("embed_bn.mean", "xvector.dense.nonlinear.batchnorm.running_mean"),
        ("embed_bn.var", "xvector.dense.nonlinear.batchnorm.running_var"),
    ]
    return rules


def ct_transformer_rules(n_layers: int) -> List[Rule]:
    """FunASR CT-Transformer punc ↔ models/ct_transformer.py: an embedding,
    a SANM encoder (same layer naming as Paraformer's), and a linear
    classifier (`decoder`)."""
    rules: List[Rule] = [("embed.table", "embed.weight")]
    rules += _enc_layer("encoder.encoders0.0", "encoder.layers.0")
    for i in range(1, n_layers):
        rules += _enc_layer(f"encoder.encoders.{i - 1}", f"encoder.layers.{i}")
    rules += [
        ("encoder.after_norm.g", "encoder.after_norm.weight"),
        ("encoder.after_norm.b", "encoder.after_norm.bias"),
        ("out.w", "decoder.weight!t"),
        ("out.b", "decoder.bias"),
    ]
    return rules


def kws_rules(n_layers: int = 4, rorder: int = 2) -> List[Rule]:
    """charctc KWS ↔ models/kws_ctc.py — the full FunASR FSMN layout
    (identical module family to fsmn_vad_rules: in_linear1/2, fsmn units,
    out_linear1/2) plus the KWS units' right-context `conv_right` kernels,
    kept as separate `wr` leaves so the map stays 1:1. Reconcile dims
    against the real `speech_charctc_kws_phone-xiaohu` dir with --diff
    (geometry itself autoloads from its config.yaml)."""
    rules = fsmn_vad_rules(n_layers)   # same FunASR FSMN module family —
    # one source of truth so transform fixes (e.g. the round-1 conv_left
    # orientation fix) can never diverge between the two families
    if rorder > 0:
        for i in range(n_layers):
            rules.append((f"blocks.{i}.fsmn.wr",
                          f"encoder.fsmn.{i}.1.conv_right.weight!squeeze"))
    return rules


def hifigan_rules(n_ups: int = 4, n_res_kernels: int = 3,
                  n_res_convs: int = 3) -> List[Rule]:
    """Standard HiFi-GAN V1 generator state_dict ↔ models/hifigan.py pytree.

    Real checkpoints store weight-normed tensors (weight_g/weight_v); run
    `fold_weight_norm` on the state dict first. Torch resblocks are a flat
    list indexed i*n_kernels + j; the tree nests [up][kernel]."""
    rules: List[Rule] = [
        ("conv_pre.w", "conv_pre.weight"),
        ("conv_pre.b", "conv_pre.bias"),
        ("conv_post.w", "conv_post.weight"),
        ("conv_post.b", "conv_post.bias"),
    ]
    for i in range(n_ups):
        rules += [(f"ups.{i}.w", f"ups.{i}.weight"),
                  (f"ups.{i}.b", f"ups.{i}.bias")]
        for j in range(n_res_kernels):
            s = f"resblocks.{i * n_res_kernels + j}"
            d = f"resblocks.{i}.{j}"
            for c in range(n_res_convs):
                rules += [
                    (f"{d}.convs1.{c}.w", f"{s}.convs1.{c}.weight"),
                    (f"{d}.convs1.{c}.b", f"{s}.convs1.{c}.bias"),
                    (f"{d}.convs2.{c}.w", f"{s}.convs2.{c}.weight"),
                    (f"{d}.convs2.{c}.b", f"{s}.convs2.{c}.bias"),
                ]
    return rules


def fold_batch_norm(sd: Dict[str, np.ndarray],
                    eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """Fold inference-time BatchNorm into its affine: for every module X
    with `X.running_mean/X.running_var`, replace X.weight/X.bias with
    w' = w/√(var+eps), b' = b − mean·w' and drop the stats — a BN at eval
    is exactly this channel affine. Modules without running stats pass
    through untouched (so invert-mode synthetic checkpoints round-trip)."""
    out: Dict[str, np.ndarray] = {}
    done = set()
    for name in sd:
        if not name.endswith("running_mean"):
            continue
        base = name[: -len("running_mean")]
        mean = np.asarray(sd[name], np.float32)
        var = np.asarray(sd[base + "running_var"], np.float32)
        w = np.asarray(sd.get(base + "weight", np.ones_like(mean)),
                       np.float32)
        b = np.asarray(sd.get(base + "bias", np.zeros_like(mean)),
                       np.float32)
        w2 = w / np.sqrt(var + eps)
        out[base + "weight"] = w2
        out[base + "bias"] = b - mean * w2
        done |= {name, base + "running_var", base + "weight", base + "bias",
                 base + "num_batches_tracked"}
    for name, arr in sd.items():
        if name not in done:
            out[name] = arr
    return out


def fold_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold torch weight_norm parametrization: weight = g · v/‖v‖ (norm over
    all dims except 0). Leaves other tensors untouched."""
    out: Dict[str, np.ndarray] = {}
    done = set()
    for name in sd:
        if name.endswith("weight_v"):
            base = name[: -len("weight_v")]  # keeps the trailing "." if any
            g = np.asarray(sd[base + "weight_g"], np.float32)
            v = np.asarray(sd[name], np.float32)
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
            out[base + "weight"] = (g * v / np.maximum(norm, 1e-12)).astype(
                np.float32)
            done.add(name)
            done.add(base + "weight_g")
    for name, arr in sd.items():
        if name not in done:
            out[name] = arr
    return out


_TRANSFORMS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "": lambda a: a,
    "t": lambda a: a.T,
    # FunASR VAD FSMNBlock conv_left is a depthwise Conv2d weight
    # [d, 1, lorder, 1] applied to LEFT-padded frames — torch conv2d and the
    # causal conv1d are both cross-correlations with kernel index 0 on the
    # OLDEST frame, so the mapping is a plain trailing-dim squeeze.
    "squeeze": lambda a: a[..., 0],
    # torch 1×1 Conv1d [out, in, 1] → linear [in, out]
    "c1x1": lambda a: a[..., 0].T,
}
_INVERSE: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "": lambda a: a,
    "t": lambda a: a.T,
    "squeeze": lambda a: a[..., None],
    "c1x1": lambda a: a.T[..., None].copy(),
}


def _parse(torch_name: str) -> Tuple[str, str]:
    if "!" in torch_name:
        name, tf = torch_name.split("!")
        return name, tf
    return torch_name, ""


# One gap report per `convert_state_dict` call (the newest 32), read by
# `tools/rehearse.py`: rules, tensors converted, missing and unmapped names.
CONVERT_REPORTS: List[Dict[str, Any]] = []


def convert_state_dict(sd: Dict[str, np.ndarray], rules: List[Rule],
                       template: Any, strict: bool = True,
                       keep_missing: bool = False) -> Any:
    """Torch state_dict (as numpy) → parameter tree shaped like `template`
    (numpy leaves).

    keep_missing: template leaves without a rule keep their template value
    — for framework-only parameters real checkpoints don't carry. A
    missing tensor raises KeyError (strict) and a shape that disagrees
    with the template ValueError."""
    names = [_parse(t)[0] for _, t in rules]
    missing = [name for name in names if name not in sd]
    consumed = set(names)
    CONVERT_REPORTS.append({
        "n_rules": len(rules),
        "n_converted": len({p for (p, _), name in zip(rules, names)
                            if name in sd}),
        "missing": list(missing),
        "unmapped": sorted(
            k for k in sd
            if k not in consumed and not k.endswith("num_batches_tracked")),
    })
    del CONVERT_REPORTS[:-32]  # bounded
    if missing:   # checked before any tensor is converted
        msg = f"{len(missing)} parameters missing from checkpoint, e.g. {missing[:5]}"
        if strict:
            raise KeyError(msg)
        logger.warning(msg)
    flat: Dict[str, np.ndarray] = {}
    for path, torch_spec in rules:
        name, tf = _parse(torch_spec)
        if name in sd:
            # row-major, so the cache and the card get the layout of a
            # drawn tree without a transposing copy at every load
            flat[path] = np.ascontiguousarray(
                _TRANSFORMS[tf](np.asarray(sd[name], dtype=np.float32)))
    return unflatten_like(template, flat, keep_missing=keep_missing)


def invert_to_state_dict(params: Any, rules: List[Rule]) -> Dict[str, np.ndarray]:
    """Parameter tree → synthetic torch-style state dict (for round-trip
    tests and for writing checkpoints in FunASR / KAN-TTS naming)."""
    flat = flatten_params(params)
    sd: Dict[str, np.ndarray] = {}
    for path, torch_spec in rules:
        name, tf = _parse(torch_spec)
        sd[name] = _INVERSE[tf](flat[path])
    return sd


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .pt/.pb/.pth checkpoint to numpy arrays on the host. The file
    is memory-mapped, so a conversion that fails on its tensor names (a
    BiCIF template tried on a plain Paraformer) reads no tensor data."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True,
                         mmap=True)
    except RuntimeError as e:
        if "mmap" not in str(e):
            raise
        # a legacy (pre-zip) torch file cannot be mapped: read it whole
        obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()
            if hasattr(v, "detach")}


def find_checkpoint(model_dir: str) -> Optional[str]:
    """The directory's torch checkpoint (`model.pt`, `model.pb` or
    `pytorch_model.bin`, in that order), or None."""
    return next((p for p in (os.path.join(model_dir, f)
                             for f in CHECKPOINT_NAMES)
                 if os.path.exists(p)), None)


def convert_or_load_cached(model_dir: str, template: Any, rules: List[Rule],
                           cache_name: str = CACHE_NAME,
                           keep_missing: bool = False,
                           pre_transform: Optional[
                               Callable[[Dict[str, np.ndarray]],
                                        Dict[str, np.ndarray]]] = None) -> Any:
    """Resolve `model_dir/model.pt` → converted tree (numpy leaves), with an
    `.npz` cache beside it.

    pre_transform: state-dict preprocessing (e.g. fold_weight_norm for
    HiFi-GAN's weight-normed generators). A directory without a checkpoint
    or a cache raises FileNotFoundError; a read-only directory still
    converts, and only the cache write is skipped, with a warning."""
    cache = os.path.join(model_dir, cache_name)
    src = find_checkpoint(model_dir)
    if os.path.exists(cache):
        # stale-cache guard: a model.pt newer than its converted npz means
        # the checkpoint was swapped (fine-tune, revision bump) — reconvert
        # instead of silently serving the old weights (same shapes, so no
        # shape check would catch it)
        if src is not None \
                and os.path.getmtime(src) > os.path.getmtime(cache):
            logger.warning("%s is newer than its converted cache %s — "
                           "reconverting", src, cache)
        else:
            return load_converted(cache, template)
    if src is None:
        raise FileNotFoundError(f"no checkpoint found under {model_dir}")
    sd = load_torch_state_dict(src)
    if pre_transform is not None:
        sd = pre_transform(sd)
    params = convert_state_dict(sd, rules, template,
                                keep_missing=keep_missing)
    del sd
    try:
        save_converted(cache, params)
    except OSError:  # read-only model dir — conversion still works
        logger.warning("could not write converted cache %s", cache)
    return params
