"""Device meshes for the DP / FSDP / TP / SP / EP / PP axes.

Counterpart: ``ray_tpu/parallel/mesh.py``. A mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group, with one named dim per ``MeshSpec`` axis; the caller starts the group
(``torch.distributed.init_process_group``) with ``spec.size`` ranks, one
device each. Rank r sits at the row-major coordinates of r in
``arange(spec.size).reshape(spec.shape)``, as JAX device r does in
``np.array(devices).reshape(spec.shape)``.

Canonical axis names (used by the sharding rules and the trainer):
  * ``dp``   -- pure data parallel (gradient all-reduce)
  * ``fsdp`` -- data parallel with parameter/optimizer sharding (ZeRO-3:
               params gathered for the forward, grads reduce-scattered)
  * ``tp``   -- tensor (Megatron) parallelism within attention/MLP blocks
  * ``sp``   -- sequence/context parallelism (ring attention over this axis)
  * ``ep``   -- expert parallelism for MoE layers
  * ``pp``   -- pipeline stages

The axis order puts tp/sp innermost (neighbouring ranks), dp/fsdp outermost
and pp outside them, as the JAX package orders its mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A declarative mesh: axis name -> size. Unlisted axes have size 1."""

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def of(cls, **sizes: int) -> "MeshSpec":
        for name in sizes:
            if name not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {name!r}; valid: {AXIS_ORDER}")
        ordered = tuple((a, sizes.get(a, 1)) for a in AXIS_ORDER if sizes.get(a, 1) > 1)
        return cls(ordered if ordered else (("dp", 1),))

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    def axis_size(self, name: str) -> int:
        for a, s in self.axes:
            if a == name:
                return s
        return 1

    @classmethod
    def auto(cls, n_devices: int, *, model_needs_tp: int = 1, fsdp: bool = True) -> "MeshSpec":
        """Simple auto-layout: give tp what the model needs, rest to fsdp/dp."""
        tp = min(model_needs_tp, n_devices)
        rest = n_devices // tp
        if fsdp:
            return cls.of(fsdp=rest, tp=tp)
        return cls.of(dp=rest, tp=tp)


MeshLike = Union[MeshSpec, "DeviceMesh"]  # noqa: F821


def mesh_axes(mesh: MeshLike) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, axis sizes) of a ``MeshSpec`` or a named ``DeviceMesh``:
    all that the sharding rules read of a mesh, so layouts need no process
    group."""
    if isinstance(mesh, MeshSpec):
        return mesh.names, mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the DeviceMesh has no mesh_dim_names; build it "
                         "with build_mesh")
    return tuple(names), tuple(mesh.mesh.shape)


def build_mesh(spec: MeshSpec, devices: Optional[Sequence[int]] = None,
               device_type: Optional[str] = None):
    """A ``DeviceMesh`` with the spec's named dims over ``devices`` (global
    ranks; all ranks of the default group if not given), whose count must
    equal ``spec.size``. ``device_type`` is ``"cuda"`` (the card) unless
    the caller asks for ``"cpu"``; on the card each rank uses its current
    device."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    if devices is None:
        devices = range(dist.get_world_size())
    devices = list(devices)
    if len(devices) != spec.size:
        raise ValueError(
            f"mesh spec needs {spec.size} devices ({dict(spec.axes)}), "
            f"got {len(devices)}"
        )
    if device_type is None:
        from ray_tpu_torch._private.device import resolve_device

        device_type = resolve_device(None).type
    ranks = torch.tensor(devices, dtype=torch.int64).reshape(spec.shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=spec.names)


def local_mesh(device_type: Optional[str] = None, **sizes: int):
    """Convenience: a mesh over every rank of the default process group."""
    return build_mesh(MeshSpec.of(**sizes), device_type=device_type)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a JAX-style partition spec (one entry per tensor dim: a
    mesh axis name, a tuple of them, or None); ``placements`` is the
    DTensor form (``sharding.spec_to_placements``)."""

    mesh: object
    spec: Tuple = ()

    @property
    def placements(self):
        from ray_tpu_torch.parallel.sharding import spec_to_placements

        return spec_to_placements(self.spec, self.mesh)


def data_sharding(mesh, batch_axes: Sequence[str] = ("dp", "fsdp")
                  ) -> NamedSharding:
    """Sharding for a [batch, ...] input: batch split over data axes."""
    names, _ = mesh_axes(mesh)
    present = tuple(a for a in batch_axes if a in names)
    if not present:
        return NamedSharding(mesh, (None,))
    return NamedSharding(mesh, (present[0] if len(present) == 1 else present,))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
