"""Multi-device scaling: device meshes, sharded encoding, sharded queries."""

from local_search_quantization.parallel import mesh
from local_search_quantization.parallel.mesh import (
    data_mesh,
    replicated,
    shard_batch,
)

__all__ = ["mesh", "data_mesh", "replicated", "shard_batch"]
