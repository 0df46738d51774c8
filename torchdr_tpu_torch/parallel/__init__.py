"""Multi-device paths over a single-process device mesh.

Counterpart of ``torchdr_tpu/parallel/``: one process drives every device
of a :class:`Mesh` (an ordered tuple of ``torch.device``s, repeats
allowed), as the JAX package drives its local chips SPMD. The JAX
package's ``row_sharding`` and ``replicated`` (``NamedSharding``s) have no
torch counterpart and are left out.
"""

from .knn import knn_graph_ring, knn_graph_sharded, knn_graph_sharded_queries
from .mesh import (
    Mesh,
    MeshConfig,
    ShardedRows,
    chunk_bounds,
    make_mesh,
    pad_to_multiple,
    rank_of_rows,
    replicate,
    shard_rows,
)
from .sparse import distributed_symmetrize_sparse

__all__ = [
    "Mesh", "ShardedRows",
    "MeshConfig", "make_mesh", "shard_rows", "replicate",
    "chunk_bounds", "rank_of_rows", "pad_to_multiple",
    "knn_graph_ring", "knn_graph_sharded", "knn_graph_sharded_queries",
    "distributed_symmetrize_sparse",
]
