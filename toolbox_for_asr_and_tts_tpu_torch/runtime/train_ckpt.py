"""Fine-tuning checkpoint and resume.

Port of `toolbox_for_asr_and_tts_tpu/runtime/train_ckpt.py` for one card,
without orbax: `<ckpt_dir>/<step>/params.pt` holds the flat parameters
(`checkpoints.flatten_params` names → tensors) and `opt_state.pt` the
optimizer's `state_dict()`, both written with `torch.save` and read with
`torch.load(weights_only=True)`. A restore copies the parameters into the
template tree's own storages, which a Recognizer's graphs bind, and gives
the optimizer the checkpoint's state (`load_state_dict`, keeping the
template's device flags); a captured training step
(`runtime/train_graph.py`) sees the new state and captures again. A step
is written into a temporary directory
beside it and moved into place with `os.replace`, so a step directory holds
both files or does not exist; `latest_step` also skips a step directory that
lacks either (a save interrupted some other way). Serving meets training at
`export_params_npz`, which writes the port's serving cache.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from . import checkpoints as ckpt

logger = logging.getLogger("toolbox.train_ckpt")

PARAMS_FILE = "params.pt"
OPT_FILE = "opt_state.pt"


def _named_leaves(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{flat name: leaf}, named as `checkpoints.flatten_params` names them
    (None leaves skipped), in the tree's order."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_named_leaves(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_named_leaves(v, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def save_train_state(ckpt_dir: str, step: int, params: Any,
                     opt_state: torch.optim.Optimizer) -> str:
    """Write <ckpt_dir>/<step>/{params.pt, opt_state.pt}, replacing an
    earlier save of the same step. Returns the step directory."""
    root = os.path.abspath(ckpt_dir)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, str(int(step)))
    tmp = tempfile.mkdtemp(prefix=f".{int(step)}.", dir=root)
    try:
        torch.save({n: t.detach().cpu()
                    for n, t in _named_leaves(params).items()},
                   os.path.join(tmp, PARAMS_FILE))
        torch.save(opt_state.state_dict(), os.path.join(tmp, OPT_FILE))
        if os.path.isdir(path):          # a save of the same step: set aside
            old = tempfile.mkdtemp(prefix=f".{int(step)}.old.", dir=root)
            os.replace(path, os.path.join(old, "step"))
            shutil.rmtree(old)
        os.replace(tmp, path)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    logger.info("saved training state step=%d at %s", step, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step whose save is complete (both files present); a step
    directory without them is skipped with a warning."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if not re.fullmatch(r"\d+", d):
            continue
        sd = os.path.join(ckpt_dir, d)
        if os.path.isfile(os.path.join(sd, PARAMS_FILE)) \
                and os.path.isfile(os.path.join(sd, OPT_FILE)):
            steps.append(int(d))
        elif os.path.isdir(sd):
            logger.warning("ignoring incomplete checkpoint step dir %s "
                           "(interrupted save)", sd)
    return max(steps) if steps else None


def restore_train_state(ckpt_dir: str, params_template: Any,
                        opt_template: torch.optim.Optimizer,
                        step: Optional[int] = None,
                        device: DeviceLike = None
                        ) -> Optional[Tuple[int, Any, Any]]:
    """Restore (step, params, opt_state) into the templates, in place (the
    template tree's storages, which a Recognizer's graphs may bind, keep
    their identity); None when no checkpoint exists. device: where the
    saved tensors are loaded, the card unless "cpu" is passed."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None
    path = os.path.join(os.path.abspath(ckpt_dir), str(int(step)))
    flat = torch.load(os.path.join(path, PARAMS_FILE), map_location=dev,
                      weights_only=True)
    leaves = _named_leaves(params_template)
    missing = [n for n in leaves if n not in flat]
    if missing:
        raise KeyError(f"missing parameter {missing[0]} in {path}")
    with torch.no_grad():
        for name, leaf in leaves.items():
            if tuple(flat[name].shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {name}: checkpoint "
                                 f"{tuple(flat[name].shape)} vs model "
                                 f"{tuple(leaf.shape)}")
            leaf.copy_(flat[name])
    load_opt_state(opt_template, torch.load(
        os.path.join(path, OPT_FILE), map_location="cpu", weights_only=True))
    logger.info("restored training state step=%d from %s", step, path)
    return int(step), params_template, opt_template


# the template's own: how its optimizer runs on its device, not the run's
# numbers (a captured step's capturable checkpoint restores into an eager
# optimizer, a CPU run's into a card's)
_DEVICE_FLAGS = ("capturable", "foreach", "fused", "differentiable")


def load_opt_state(opt: torch.optim.Optimizer, saved: Dict[str, Any]) -> None:
    """`opt.load_state_dict(saved)` (read on the host: moments onto the
    parameters' device, step counts where the optimizer's flags put them),
    with the optimizer's own device flags kept."""
    groups, saved_groups = opt.param_groups, saved["param_groups"]
    if len(groups) != len(saved_groups) or any(
            len(g["params"]) != len(s["params"])
            for g, s in zip(groups, saved_groups)):
        raise ValueError("the saved optimizer state has other parameter "
                         "groups than the optimizer")
    opt.load_state_dict(dict(saved, param_groups=[
        dict(s, **{k: g[k] for k in _DEVICE_FLAGS if k in g})
        for g, s in zip(groups, saved_groups)]))


def export_params_npz(params: Any, out_path: str) -> str:
    """Training params → the port's serving `.npz` (`save_converted`), so
    `load_converted` and `Recognizer.from_model_dir` (as its
    `torch_params.npz`) serve a fine-tuned tree. The directory is made
    where it does not exist yet."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    ckpt.save_converted(out_path, params)
    return out_path
