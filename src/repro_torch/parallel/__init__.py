"""Distribution: sharding rules and the activation policy of the mesh
(``repro/parallel``; its gradient compression, ``compress.py``, waits for
mesh training)."""
from .sharding import (
    param_sharding, cache_sharding, batch_sharding, dp_axes, tree_shardings,
    replicated, leaf_sharding, place_tree,
)
