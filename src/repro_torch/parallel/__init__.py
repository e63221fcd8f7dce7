"""Distribution: sharding rules, the activation policy of the mesh and
its collectives with a backward (``repro/parallel``), and gradient
compression with error feedback (``compress.py``)."""
from .sharding import (
    param_sharding, cache_sharding, batch_sharding, dp_axes, tree_shardings,
    replicated, leaf_sharding, place_tree, place_throughput,
    gather_throughput,
)
