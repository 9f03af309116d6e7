"""Paraformer fine-tuning step on one card.

Port of `toolbox_for_asr_and_tts_tpu/parallel/trainstep.py` (its single-card
half; the dp + tp mesh waits for the multi-card slice). Loss = masked token
cross-entropy + the CIF quantity loss (|Σα − target length|), with
teacher-forced CIF: α scaled so that Σα equals the target length, no tail
frame mass (`tail_threshold=0.0`), as in the Paraformer paper and FunASR.

The parameters are the port's plain-dict tree; the step makes its leaves
require grad and updates them in place, so the tree stays the one a
`Recognizer` holds (its captured graphs bind those storages). Autograd runs
through kernel K1 (`ops/kernels/fsmn_conv.py::FsmnDepthwiseFn`: dx and dw
by one launch of K1's backward kernel, `fsmn_conv_dw.fsmn_conv_bwd`). The
step runs eagerly.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models import paraformer
from ..models.convert import tree_map
from ..ops import nn

# optax.adamw's defaults: lr, b1, b2, eps, and weight_decay 1e-4 (torch's
# own default is 1e-2); both decay decoupled from the gradient
ADAMW_DEFAULTS = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                      weight_decay=1e-4)


def adamw(lr: float = 1e-4) -> Callable[[List[torch.Tensor]],
                                        torch.optim.Optimizer]:
    """The reference's `optax.adamw(lr)` as an optimizer factory: leaves →
    `torch.optim.AdamW` with optax's defaults."""
    return functools.partial(torch.optim.AdamW,
                             **dict(ADAMW_DEFAULTS, lr=lr))


def param_leaves(params: Any) -> List[torch.Tensor]:
    """The tree's tensors in its own order (None leaves skipped)."""
    out: List[torch.Tensor] = []
    tree_map(out.append, params)
    return out


def _refuse_quantized(params: Any) -> None:
    """Raise on a tree with integer leaves: an int8-quantized tree
    (`paraformer.quantize_encoder_int8`) serves only, as the reference's
    docstring says; its rounding has no gradient."""
    ints = sorted({str(p.dtype) for p in param_leaves(params)
                   if not p.is_floating_point()})
    if ints:
        raise ValueError(f"a quantized tree ({', '.join(ints)} leaves) "
                         "serves only and does not train")


def paraformer_loss(params, feats, feat_lens, targets, target_lens,
                    cfg: paraformer.ParaformerConfig,
                    quantity_weight: float = 1.0
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """feats [B, T, D], feat_lens [B], targets [B, K] int (0-padded),
    target_lens [B] → (loss, {"ce", "quantity"})."""
    t = feats.shape[1]
    k_max = targets.shape[1]
    mask = nn.length_mask(feat_lens, t)
    enc = paraformer.encode(params, feats, mask, cfg)
    alphas = paraformer.predictor_alphas(params, enc, mask, cfg)
    # teacher-forced CIF: scale α so Σα == target length (FunASR training)
    total = alphas.sum(dim=1, keepdim=True)
    lens = target_lens.float()
    alphas_scaled = alphas * (lens[:, None]
                              / torch.maximum(total, total.new_full((), 1e-6)))
    embeds = paraformer.cif(enc, alphas_scaled, k_max, tail_threshold=0.0)[0]
    tok_mask = nn.length_mask(target_lens, k_max)
    logits = paraformer.decode(params, embeds, tok_mask, enc, mask, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    ce = (ce * tok_mask).sum() / torch.maximum(tok_mask.sum(),
                                               tok_mask.new_full((), 1.0))
    quantity = (total[:, 0] - lens).abs().mean()
    return ce + quantity_weight * quantity, {"ce": ce, "quantity": quantity}


def make_train_step(cfg: paraformer.ParaformerConfig,
                    optimizer: Optional[Callable[[List[torch.Tensor]],
                                                 torch.optim.Optimizer]] = None,
                    device: DeviceLike = None):
    """(init_opt, train_step), as the reference's.

    optimizer: a factory from the parameter leaves to a torch optimizer
    (default `adamw(1e-4)`, optax's `adamw(1e-4)`); device: where the
    parameters live and the batch goes, the card unless "cpu" is passed.
    `init_opt(params)` makes the leaves require grad and returns the
    optimizer (the step's `opt_state`); `train_step(params, opt_state,
    batch)` updates the leaves in place and returns (params, opt_state,
    {"loss", "ce", "quantity"}) with the metrics detached on the device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:   # "cuda": the current card
        dev = torch.device("cuda", torch.cuda.current_device())
    make_opt = optimizer or adamw()

    def init_opt(params) -> torch.optim.Optimizer:
        _refuse_quantized(params)
        leaves = param_leaves(params)
        for p in leaves:
            if p.device != dev:
                raise ValueError(f"parameter on {p.device}, the step runs "
                                 f"on {dev}")
            p.requires_grad_(True)
        return make_opt(leaves)

    def train_step(params, opt_state: torch.optim.Optimizer,
                   batch: Dict[str, Any]) -> Tuple[Any, Any, Dict]:
        _refuse_quantized(params)
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        opt_state.zero_grad(set_to_none=True)
        loss, aux = paraformer_loss(params, b["feats"], b["feat_lens"],
                                    b["targets"], b["target_lens"], cfg)
        loss.backward()
        opt_state.step()
        return params, opt_state, {"loss": loss.detach(),
                                   **{k: v.detach() for k, v in aux.items()}}

    return init_opt, train_step
