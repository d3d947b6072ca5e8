"""The multi-device layer on ``torch.distributed`` (port of
``ttamm_tpu/parallel/``): one process per device, a ``(data, model)``
``DeviceMesh``, row-sharded tables with shard-local sparse-row Adam, the all-to-all
embedding exchange (``mesh.embedding_exchange: alltoall``,
``exchange.py``), tensor parallelism of the dense tower layers
(``mesh.tensor_parallel``: Megatron column / row slices over ``model``,
``sharding.py``, ``mesh.copy_to_axis``), the sharded eval search and the
wire inventory (``collective_inspect.py``, the counterpart of
``hlo_inspect.py``: every collective goes through ``mesh.py``'s helpers,
which a record lists while it is open)."""

from .launch import is_primary_host, maybe_initialize_distributed
from .mesh import DATA_AXIS, MODEL_AXIS, MeshConfig, build_mesh, parse_mesh_config, round_up
from .sharding import (
    encode_model,
    gather_state_flat,
    logical_rows,
    pad_batch_data,
    pad_state_rows,
    padded_rows,
    place_data,
    place_state,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "MeshConfig",
    "build_mesh",
    "encode_model",
    "gather_state_flat",
    "is_primary_host",
    "logical_rows",
    "maybe_initialize_distributed",
    "pad_batch_data",
    "pad_state_rows",
    "padded_rows",
    "parse_mesh_config",
    "place_data",
    "place_state",
    "round_up",
]
