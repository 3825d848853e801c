"""Sharding rules over a mesh shape, their DeviceMesh and DTensor
placements, and the activation-constraint hooks."""
from repro_torch.distributed.sharding import (ShardingRules, fit_spec,
                                              placements, shard_factor,
                                              to_device_mesh)

__all__ = ["ShardingRules", "fit_spec", "shard_factor", "to_device_mesh",
           "placements"]
