"""Parameter trees between the reference and the port.

The reference keeps parameters as nested dicts (and lists) of arrays with
fixed keys and layouts; the port uses the same tree of torch tensors. A tree
fetched from the reference as numpy arrays converts leaf for leaf, so both
sides compute the same function.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply `fn` to every leaf of a tree of dicts, lists and tuples. A None
    leaf (an absent branch, such as CAM++'s `sc` shortcut or the last
    block's `transit`) stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_to(tree: Any, device: torch.device,
            dtype: torch.dtype = None) -> Any:
    """Move a tensor tree to `device`, casting floating leaves to `dtype`
    (integer leaves, such as an int8-quantized linear's `w`, keep theirs)."""
    def move(a: torch.Tensor) -> torch.Tensor:
        if dtype is not None and a.is_floating_point():
            return a.to(device, dtype)
        return a.to(device)
    return tree_map(move, tree)


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = torch.float32) -> Any:
    """Numpy (or any array-like) parameter tree → torch tree on `device`
    (resolved as every entry point: the card unless "cpu" is passed), with
    floating leaves cast to `dtype`; `dtype=None` keeps every leaf's own
    dtype (a bf16 tree from the reference stays bf16). Integer leaves keep
    theirs, so a tree the reference quantized (`quantize_encoder_int8`:
    int8 `w`, f32 `s`) converts as it is. Every leaf converts alike, so
    BatchNorm statistics (`mean`, `var`) and extra taps such as KWS's `wr`
    need no rule of their own; None leaves stay None."""
    dev = resolve_device(device)

    def leaf(a: Any) -> torch.Tensor:
        # writable and row-major, copied only where it is not: a
        # converted checkpoint's leaves then have the layout (and the
        # results) of a drawn tree
        arr = np.require(a, requirements=("C", "W"))
        if arr.dtype.name == "bfloat16":   # ml_dtypes' bf16: same bits
            return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(arr)

    return tree_to(tree_map(leaf, tree), dev, dtype)
