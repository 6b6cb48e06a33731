"""Distribution substrate of the port.

``sharding``: the logical-axis rules of the LM stack (``MeshRules``,
``use_rules``, ``logical_sharding``) and the CEP fleet's ``cep`` mesh
axis with the one split rule of the K-partition data plane (its
blocks, ``Blocks``, each resident on its own device).
``collectives``: the int8 error-feedback compressed gradient all-reduce
over a ``torch.distributed`` group.
"""

from .sharding import (  # noqa: F401
    CEP_AXIS,
    DEFAULT_RULES,
    BlockLayout,
    Blocks,
    CepMesh,
    MeshRules,
    PartitionSpec,
    block_row,
    cep_mesh,
    current_rules,
    local_devices,
    logical_constraint,
    logical_sharding,
    map_blocks,
    resolve_cep_mesh,
    set_rules,
    to_host,
    use_rules,
)
