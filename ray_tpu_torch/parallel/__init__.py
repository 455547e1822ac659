from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, local_mesh  # noqa: F401
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardingRules,
    logical_to_spec,
    shard_params,
)
from ray_tpu_torch.parallel.slices import SliceTopology, slice_placement_group  # noqa: F401
