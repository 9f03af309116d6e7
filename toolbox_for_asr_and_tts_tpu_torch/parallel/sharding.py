"""Parameter and batch sharding rules over a (data, model) mesh.

Port of `toolbox_for_asr_and_tts_tpu/parallel/sharding.py`:

- the data axis splits batch rows (concurrent streams, training rows);
- the model axis splits the big products tensor-parallel (FFN hidden,
  attention projections, the vocabulary projection and embedding).

The rules match flat parameter paths by name, so they apply to every model
family's tree alike. Where the reference hands `NamedSharding`s to XLA,
which inserts the collectives, the port places each position's piece
itself (`shard_params`) and runs each split product shard-wise on the
model positions (`TPLinear`, `TPEmbedding`): a column-parallel product
joins its shards' output columns, a row-parallel one sums its shards'
partial products, and a vocabulary-parallel table sums the rows each shard
owns. No whole weight is gathered onto one device.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import nn
from ..runtime.mesh import (Mesh, Placement, Sharded, Spec, local_devices,
                            place)

# (regex on flat path, spec factory given the array's ndim)
_RULES = [
    # FFN: first projection column-parallel, second row-parallel
    (re.compile(r"\bffn\.w1\.w$"), lambda nd: (None, "model")),
    (re.compile(r"\bffn\.w1\.b$"), lambda nd: ("model",)),
    (re.compile(r"\bffn\.w2\.w$"), lambda nd: ("model", None)),
    # attention: qkv column-parallel, out row-parallel
    (re.compile(r"\b(qkv|kv)\.w$"), lambda nd: (None, "model")),
    (re.compile(r"\b(qkv|kv)\.b$"), lambda nd: ("model",)),
    (re.compile(r"\battn\.out\.w$|\bsrc_attn\.out\.w$"),
     lambda nd: ("model", None)),
    # vocab projection column-parallel
    (re.compile(r"\bdecoder\.out\.w$|\bout_vocab\.w$"),
     lambda nd: (None, "model")),
    (re.compile(r"\bdecoder\.out\.b$|\bout_vocab\.b$"), lambda nd: ("model",)),
    # embeddings row-parallel over vocab
    (re.compile(r"\bembed\.table$"), lambda nd: ("model", None)),
]


def spec_for_path(path: str, ndim: int) -> Spec:
    """The spec of one flat parameter path: the first rule that matches and
    fits `ndim`, else () (replicated)."""
    for rx, fn in _RULES:
        if rx.search(path):
            spec = fn(ndim)
            if len(spec) <= ndim:
                return spec
    return ()


def _flat_paths(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_paths(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _map_paths(fn, tree: Any, prefix: str = "") -> Any:
    """tree with each leaf replaced by fn(flat path, leaf)."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_paths(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def param_shardings(params: Any, mesh: Mesh) -> Any:
    """A tree of `Placement`s matching `params` (tp rules, else
    replicated)."""
    return _map_paths(
        lambda path, a: Placement(mesh, spec_for_path(path, a.dim())), params)


def shard_params(params: Any, mesh: Mesh) -> Any:
    """Place every leaf by its rule: a tree of `Sharded` leaves in which
    each mesh position holds its own tensor (its piece of a split leaf, a
    copy of a replicated one), so the data replicas of a leaf are separate
    tensors even where positions share a card."""
    def put(path: str, a: torch.Tensor) -> Sharded:
        sh = place(a, Placement(mesh, spec_for_path(path, a.dim())))
        seen = {a.untyped_storage().data_ptr()}
        for i, t in enumerate(sh.shards):
            if t.untyped_storage().data_ptr() in seen:   # a view or alias
                t = t.clone(memory_format=torch.contiguous_format)
            sh.shards[i] = t.contiguous()
            seen.add(t.untyped_storage().data_ptr())
        return sh
    return _map_paths(put, params)


def data_sharding(mesh: Mesh) -> Placement:
    return Placement(mesh, ("data",))


def make_2d_mesh(n_devices: int, model_parallel: int = 2,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 device: DeviceLike = None) -> Mesh:
    """(data, model) mesh over `n_devices` positions, the model axis capped
    by divisibility. The positions are the local devices of `device`'s
    platform (the cards unless "cpu" is passed) and too few of them raise,
    as in the reference; an explicit `devices` list (which may repeat a
    device: [cuda:0] * 4 puts four positions on one card) is taken as
    given."""
    if devices is None:
        avail = local_devices(resolve_device(device).type)
        if len(avail) < n_devices:
            raise ValueError(
                f"make_2d_mesh: requested {n_devices} devices but only "
                f"{len(avail)} available; pass devices= to place several "
                "positions on one device")
    else:
        avail = [torch.device(d) for d in devices]
        if len(avail) != n_devices:
            raise ValueError(f"make_2d_mesh: {len(avail)} devices given "
                             f"for {n_devices} positions")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = avail[:n_devices]
    mp = model_parallel
    while n_devices % mp != 0 and mp > 1:
        mp -= 1
    return Mesh(grid.reshape(n_devices // mp, mp), ("data", "model"))


# ------------------------------------------------- shard-wise products
def _sum_on(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Σ parts on `device`, in shard order (the port's psum)."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


class TPLinear:
    """A linear whose weight splits over the model positions of one data
    row; called by `nn.linear` in place of its parameter dict.

    column: w [in, out/n] per shard (and its bias piece): each shard
    multiplies x on its own device, and the output columns are joined on
    x's device, so a qkv product splits into q | k | v only after the join
    (the column split need not fall on those boundaries). row: w [in/n,
    out] per shard: each shard multiplies its slice of x's columns, and the
    partial products are summed on x's device before the (replicated)
    bias."""

    def __init__(self, w: List[torch.Tensor], b: Any, column: bool):
        self.w, self.b, self.column = w, b, column

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        home = x.device
        if self.column:
            outs = []
            for i, w in enumerate(self.w):
                y = nn.dot(x.to(w.device), w)
                if self.b is not None:
                    y = y + self.b[i]
                outs.append(y.to(home))
            return torch.cat(outs, dim=-1)
        xs = torch.split(x, [w.shape[0] for w in self.w], dim=-1)
        y = _sum_on([nn.dot(xi.to(w.device), w)
                     for xi, w in zip(xs, self.w)], home)
        return y if self.b is None else y + self.b


class TPEmbedding:
    """A table split by rows (the vocabulary) over the model positions of
    one data row: each shard looks up the ids it owns (zeros elsewhere) and
    the lookups are summed on the ids' device."""

    def __init__(self, tables: List[torch.Tensor]):
        self.tables = tables

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        home = ids.device
        parts, lo = [], 0
        for t in self.tables:
            local = ids.to(t.device).long() - lo
            own = (local >= 0) & (local < t.shape[0])
            rows = t[local.clamp(0, t.shape[0] - 1)]
            parts.append(rows * own[..., None].to(rows.dtype))
            lo += t.shape[0]
        return _sum_on(parts, home)


def local_tree(sharded: Any, data_index: int) -> Any:
    """The tree data row `data_index` of a (data, model) mesh computes
    with: split linears and tables become `TPLinear` / `TPEmbedding` over
    the row's model positions, and every other leaf is the row's first
    model position's copy (the row's replicated work runs there)."""
    def pick(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, Sharded) and "model" in w.sharding.spec:
                return _tp_linear(node, data_index)
            t = node.get("table")
            if isinstance(t, Sharded) and "model" in t.sharding.spec:
                return TPEmbedding(row_pieces(t, data_index))
            return {k: pick(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [pick(v) for v in node]
        if isinstance(node, Sharded):
            return row_pieces(node, data_index)[0]
        return node
    return pick(sharded)


def row_pieces(leaf: Sharded, data_index: int) -> List[torch.Tensor]:
    """The tensors of data row `data_index`'s model positions, in order."""
    mesh = leaf.sharding.mesh
    n_model = mesh.shape.get("model", 1)
    return leaf.shards[data_index * n_model:(data_index + 1) * n_model]


def _tp_linear(node: dict, d: int) -> TPLinear:
    w = node["w"]
    column = w.sharding.spec == (None, "model")
    b = node.get("b")
    if b is not None:
        b = (row_pieces(b, d) if "model" in b.sharding.spec
             else row_pieces(b, d)[0])
    return TPLinear(row_pieces(w, d), b, column)
