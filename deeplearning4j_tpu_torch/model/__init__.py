from . import zoo
from .serializer import (
    load_jax_params,
    read_normalizer,
    restore_computation_graph,
    restore_model,
    restore_multi_layer_network,
    write_model,
)

__all__ = ["load_jax_params", "read_normalizer", "restore_computation_graph",
           "restore_model", "restore_multi_layer_network", "write_model", "zoo"]
