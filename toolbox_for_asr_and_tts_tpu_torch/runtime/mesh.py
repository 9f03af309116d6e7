"""Device mesh for serving and training: a grid of `torch.device`s.

Port of `toolbox_for_asr_and_tts_tpu/runtime/mesh.py`. The reference is
single-controller: one serving process owns every local chip, and
`serving_mesh()` is a 1-axis `jax.sharding.Mesh` over `jax.devices()`; a
batch's leading axis shards over it. The port keeps that design: one
process drives every position of a `Mesh`, an ndarray of `torch.device`s
with named axes, and a collective is a `Tensor.to(device)` plus a
`torch.cat` or a sum (autograd differentiates `Tensor.to`, so a backward
pass sends each gradient back the way its tensor came, as autodiff does for
the reference's `all_gather`, `ppermute` and `psum`).

A mesh may name one device at several positions: `[cuda:0, cuda:0]` is a
2-position mesh on one card, as the reference's tests run 8 virtual CPU
devices. Each position then still runs its own share of the work (its own
programs and kernel launches), so one card checks the sharded arithmetic.

`serving_mesh()` covers `torch.cuda.device_count()` cards, or one CPU
position with `device="cpu"`; tests widen the CPU list by monkeypatching
`local_devices`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.convert import tree_map, tree_to

BATCH_AXIS = "data"

Spec = Tuple[Optional[str], ...]   # PartitionSpec: one axis name (or None)
                                   # per leading dimension; () replicates


def local_devices(platform: str = "cuda") -> List[torch.device]:
    """The process's devices of `platform`: every visible card for
    "cuda", one position for "cpu"."""
    if platform == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(platform)]


def local_device_count(platform: str = "cuda") -> int:
    return len(local_devices(platform))


class Mesh:
    """An ndarray of `torch.device`s with one name per axis; `.shape` maps
    each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        if not all(isinstance(d, torch.device) for d in grid.flat):
            raise TypeError("a mesh holds torch.device objects")
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def positions(self) -> List[torch.device]:
        """Every position's device, in row-major order."""
        return list(self.devices.flat)

    def along(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, at index 0 of every other axis (work
        replicated over those runs once, on these)."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def serving_mesh(n_devices: Optional[int] = None, axis: str = BATCH_AXIS,
                 device: DeviceLike = None) -> Mesh:
    """A 1-D mesh over (up to `n_devices` of) the local devices of
    `device`'s platform (the cards unless "cpu" is passed). Serving is data
    parallel: the leading batch axis of every model input shards over it.
    A one-card host gets a 1-position mesh, so serving code is
    mesh-agnostic."""
    platform = resolve_device(device).type
    devices = local_devices(platform)
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise RuntimeError(f"no {platform} device for a serving mesh")
    return Mesh(devices, (axis,))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor's pieces live: the stand-in for the reference's
    `NamedSharding(mesh, P(*spec))`. Dimension i of the tensor splits
    evenly over mesh axis `spec[i]` (None: not split); positions along the
    axes the spec does not name hold copies."""
    mesh: Mesh
    spec: Spec = ()

    @property
    def num_devices(self) -> int:
        return int(self.mesh.devices.size)


def batch_sharding(mesh: Mesh, axis: str = BATCH_AXIS) -> Placement:
    """The leading (batch / stream) axis split over `axis`."""
    return Placement(mesh, (axis,))


def replicated_sharding(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


@dataclasses.dataclass
class Sharded:
    """A tensor placed by `placement`: `shards[i]` is the piece that mesh
    position i (row-major) holds, on that position's device."""
    shards: List[torch.Tensor]
    sharding: Placement

    def gather(self) -> torch.Tensor:
        """The whole tensor on position 0's device: the pieces of the first
        position along every axis the spec does not name, joined along the
        dimensions it splits."""
        dev = self.shards[0].device
        mesh, spec = self.sharding.mesh, self.sharding.spec
        shape = mesh.devices.shape

        def join(dim: int, idx: List[int]) -> torch.Tensor:
            if dim == len(spec):
                return self.shards[np.ravel_multi_index(idx, shape)].to(dev)
            if spec[dim] is None:
                return join(dim + 1, idx)
            ax = mesh.axis_names.index(spec[dim])
            return torch.cat([join(dim + 1, idx[:ax] + [k] + idx[ax + 1:])
                              for k in range(shape[ax])], dim=dim)
        return join(0, [0] * len(shape))


def place(x: Any, placement: Placement) -> Sharded:
    """Split one tensor (or array) by `placement` onto its mesh."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    mesh, spec = placement.mesh, placement.spec
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more axes than the tensor's "
                         f"{t.dim()} dimensions")
    shape = mesh.shape
    shards = []
    for idx in np.ndindex(*mesh.devices.shape):
        piece = t
        for dim, name in enumerate(spec):
            if name is None:
                continue
            n = shape[name]
            if t.shape[dim] % n:
                raise ValueError(f"dimension {dim} of size {t.shape[dim]} "
                                 f"does not split over {name}={n}")
            step = t.shape[dim] // n
            k = idx[mesh.axis_names.index(name)]
            piece = piece.narrow(dim, k * step, step)
        shards.append(piece.to(mesh.devices[idx]))
    return Sharded(shards, placement)


def shard_batch(mesh: Mesh, batch: Any, axis: str = BATCH_AXIS) -> Any:
    """Place a tree of host arrays (or tensors) with the leading axis split
    over `axis`. The leading dim must be divisible by the axis size:
    callers go through `runtime.bucketing.Bucketer.pad_batch` first."""
    sh = batch_sharding(mesh, axis)
    return tree_map(lambda x: place(x, sh), batch)


def per_position(tree: Any, devices: Sequence[torch.device]) -> List[Any]:
    """A tensor tree (or None) for each of `devices`, one per mesh
    position: one copy per distinct device, and the tree itself on the
    device where it already lies."""
    copies: Dict[torch.device, Any] = {}
    for d in devices:
        if d not in copies:
            copies[d] = tree_to(tree, d)
    return [copies[d] for d in devices]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
