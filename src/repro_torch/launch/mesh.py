"""Mesh shapes: axis names and sizes, with no devices behind them.

The port of ``repro/launch/mesh.py``. The JAX package builds a real
``jax.sharding.Mesh`` of the 256- or 512-chip v5e pod; its sharding
rules read only the mesh's ``axis_names`` and ``shape``. One H100 has no
such mesh, so here a mesh is a :class:`MeshShape`, which the port's
rules (``distributed/sharding.py``) and the dry-run read the same way.
``distributed.sharding.to_device_mesh`` turns one into a
``torch.distributed`` ``DeviceMesh`` where a process group of its size
runs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshShape:
    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The JAX package's pod mesh: 16x16 = 256 chips; 2 pods = 512."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(*, model: int = 1) -> MeshShape:
    """One host's mesh: (1, model) over ("data", "model"); model=1 is one
    card, where every leaf stays whole."""
    return MeshShape(("data", "model"), (1, model))


# the meshes ``launch/dryrun.py`` analyses, by name
MESHES = {"1xH100": lambda: make_host_mesh(),
          "16x16": lambda: make_production_mesh(),
          "2x16x16": lambda: make_production_mesh(multi_pod=True)}
