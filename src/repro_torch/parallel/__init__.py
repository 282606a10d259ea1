"""The parallel layer: sharding rules and DTensor placements, int8
error-feedback compression, the hierarchical pod reduce. The JAX package's
``compat`` shim (``shard_map``/``set_mesh`` across JAX versions) has no
counterpart; ``use_mesh``/``get_ambient_mesh`` stand for its ambient mesh."""
from repro_torch.parallel.collectives import (
    hierarchical_grad_reduce, inter_pod_bytes_per_step, make_hierarchical_allreduce,
)
from repro_torch.parallel.compression import (
    compress_with_feedback, compressed_psum, dequantize_int8, quantize_int8,
)
from repro_torch.parallel.sharding import (
    P, Sharding, ShardingRules, get_ambient_mesh, named, placements, use_mesh,
)

__all__ = [
    "hierarchical_grad_reduce", "inter_pod_bytes_per_step",
    "make_hierarchical_allreduce", "compress_with_feedback", "compressed_psum",
    "dequantize_int8", "quantize_int8", "ShardingRules", "named",
    "P", "Sharding", "placements", "use_mesh", "get_ambient_mesh",
]
