"""Paraformer fine-tuning step, on one card or dp + tp over a mesh.

Port of `toolbox_for_asr_and_tts_tpu/parallel/trainstep.py`. Loss = masked
token cross-entropy + the CIF quantity loss (|Σα − target length|), with
teacher-forced CIF: α scaled so that Σα equals the target length, no tail
frame mass (`tail_threshold=0.0`), as in the Paraformer paper and FunASR.

The parameters are the port's plain-dict tree; the step makes its leaves
require grad and updates them in place, so the tree stays the one a
`Recognizer` holds (its captured graphs bind those storages). Autograd runs
through kernel K1 (`ops/kernels/fsmn_conv.py::FsmnDepthwiseFn`: dx and dw
by one launch of K1's backward kernel, `fsmn_conv_dw.fsmn_conv_bwd`). The
step runs eagerly; `runtime/train_graph.py::capture_train_step` makes it
one CUDA graph per batch shape, the reference's `jax.jit` of it.

Over a mesh (`make_train_step(cfg, mesh=...)`) the step is the reference's
dp + tp `jit` over `shard_params` trees (`tests/test_parallel_llm.py`):
rows split over "data", the rule-matched products over "model"
(`parallel/sharding.py`), one backward pass over all positions, gradients
summed over the data replicas, one optimizer over every position's pieces.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import paraformer
from ..models.convert import tree_map
from ..ops import nn
from ..runtime.mesh import Sharded
from .sharding import local_tree, row_pieces

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


def loss_terms(params, feats, feat_lens, targets, target_lens,
               cfg: paraformer.ParaformerConfig) -> Dict[str, torch.Tensor]:
    """The sums the loss is made of, for a batch or a shard of one:
    "ce_sum" (the masked token cross-entropy summed), "tokens" (the target
    tokens), "quantity_sum" (|Σα − target length| summed over rows) and
    "rows". A data-sharded step adds these over its shards before it
    divides (`reduce_loss`), so its loss is the whole batch's."""
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
    return {"ce_sum": (ce * tok_mask).sum(), "tokens": tok_mask.sum(),
            "quantity_sum": (total[:, 0] - lens).abs().sum(),
            "rows": lens.new_full((), float(lens.shape[0]))}


def reduce_loss(terms: Dict[str, torch.Tensor],
                quantity_weight: float = 1.0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"ce", "quantity"}) from `loss_terms`' sums: the token-mean
    cross-entropy plus the row-mean quantity loss, as the reference's."""
    tokens = terms["tokens"]
    ce = terms["ce_sum"] / torch.maximum(tokens, tokens.new_full((), 1.0))
    quantity = terms["quantity_sum"] / terms["rows"]
    return ce + quantity_weight * quantity, {"ce": ce, "quantity": quantity}


def paraformer_loss(params, feats, feat_lens, targets, target_lens,
                    cfg: paraformer.ParaformerConfig,
                    quantity_weight: float = 1.0
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """feats [B, T, D], feat_lens [B], targets [B, K] int (0-padded),
    target_lens [B] → (loss, {"ce", "quantity"})."""
    return reduce_loss(loss_terms(params, feats, feat_lens, targets,
                                  target_lens, cfg), quantity_weight)


def make_train_step(cfg: paraformer.ParaformerConfig,
                    optimizer: Optional[Callable[[List[torch.Tensor]],
                                                 torch.optim.Optimizer]] = None,
                    device: DeviceLike = None, mesh=None):
    """(init_opt, train_step), as the reference's.

    mesh: a (data, model) mesh (`parallel/sharding.py::make_2d_mesh`, or
    a 1-D data mesh): the step then takes the tree `shard_params(params,
    mesh)` gives, as the reference's jitted step takes `shard_params`'
    arrays, and runs dp + tp (`_mesh_step`); `device` is not used.

    optimizer: a factory from the parameter leaves to a torch optimizer
    (default `adamw(1e-4)`, optax's `adamw(1e-4)`); device: where the
    parameters live and the batch goes, the card unless "cpu" is passed.
    `init_opt(params)` makes the leaves require grad and returns the
    optimizer (the step's `opt_state`); `train_step(params, opt_state,
    batch)` updates the leaves in place and returns (params, opt_state,
    {"loss", "ce", "quantity"}) with the metrics detached on the device."""
    if mesh is not None:
        return _mesh_step(cfg, optimizer or adamw(), mesh)
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


# ------------------------------------------------------------- dp + tp
def _pieces(sharded) -> List[Tuple[Sharded, List[List[torch.Tensor]]]]:
    """Per leaf: its trained tensors grouped by model index, each group the
    data replicas of one piece: a split leaf trains every position's
    piece, a replicated one the copy of each data row's first model
    position (where that row's replicated work runs)."""
    out = []

    def visit(leaf: Sharded):
        mesh = leaf.sharding.mesh
        n_data = mesh.shape.get("data", 1)
        rows = [row_pieces(leaf, d) for d in range(n_data)]
        split = "model" in leaf.sharding.spec
        n = len(rows[0]) if split else 1
        out.append((leaf, [[rows[d][m] for d in range(n_data)]
                           for m in range(n)]))
    tree_map(visit, sharded)
    return out


def _mesh_step(cfg: paraformer.ParaformerConfig,
               make_opt: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
               mesh):
    """dp + tp over `mesh`. Batch rows split over "data"; each data row
    computes `loss_terms` on its rows with its own tree (`local_tree`: the
    split products run shard-wise on the row's model positions, the rest
    on its first one). The terms' numerators and denominators add up over
    the rows before one division (`reduce_loss`), so the loss is the whole
    batch's, never a mean of shard losses; one backward pass then reaches
    every position. Each piece's gradient is summed over its data
    replicas in row order onto row 0's copy and copied back to every
    replica (the reference's psum), so the optimizer updates every replica
    alike and the replicas stay bit-equal; the copies of replicated leaves
    on a row's other model positions then take row 0's values."""
    n_data = mesh.shape.get("data", 1)

    def init_opt(sharded) -> torch.optim.Optimizer:
        trained = []
        for leaf, groups in _pieces(sharded):
            for g in groups:
                for t in g:
                    if not t.is_floating_point():
                        raise ValueError(
                            f"a quantized tree ({t.dtype} leaves) serves "
                            "only and does not train")
                    t.requires_grad_(True)
                    trained.append(t)
        return make_opt(trained)

    def train_step(sharded, opt_state: torch.optim.Optimizer,
                   batch: Dict[str, Any]) -> Tuple[Any, Any, Dict]:
        b = {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v) for k, v in batch.items()}
        n_rows = b["feats"].shape[0]
        if n_rows % n_data:
            raise ValueError(f"batch of {n_rows} rows does not split over "
                             f"data={n_data}")
        per = n_rows // n_data
        opt_state.zero_grad(set_to_none=True)
        home = mesh.devices.reshape(n_data, -1)[0, 0]
        total: Dict[str, torch.Tensor] = {}
        for d in range(n_data):
            dev = mesh.devices.reshape(n_data, -1)[d, 0]
            part = {k: v[d * per:(d + 1) * per].to(dev) for k, v in b.items()}
            terms = loss_terms(local_tree(sharded, d), part["feats"],
                               part["feat_lens"], part["targets"],
                               part["target_lens"], cfg)
            for k, v in terms.items():
                total[k] = v.to(home) if k not in total \
                    else total[k] + v.to(home)
        loss, aux = reduce_loss(total)
        loss.backward()
        pieces = _pieces(sharded)
        with torch.no_grad():
            for _, groups in pieces:
                for replicas in groups:
                    grads = [t.grad for t in replicas]
                    if grads[0] is None:
                        continue
                    g = grads[0].clone()
                    for other in grads[1:]:
                        g += other.to(g.device)
                    for t in replicas:
                        t.grad.copy_(g)
        opt_state.step()
        with torch.no_grad():
            for leaf, groups in pieces:
                if "model" in leaf.sharding.spec:
                    continue
                for d in range(n_data):
                    row = row_pieces(leaf, d)
                    for t in row[1:]:
                        if t is not row[0]:
                            t.copy_(row[0])
        return sharded, opt_state, {"loss": loss.detach(),
                                    **{k: v.detach() for k, v in aux.items()}}

    return init_opt, train_step
