"""Distribution substrate of the port.

``sharding``: the logical-axis rules of the LM stack (``MeshRules``,
``use_rules``, ``logical_sharding``) and the CEP fleet's ``cep`` mesh
axis with the one split rule of the K-partition data plane.
``collectives``: the int8 error-feedback compressed gradient all-reduce
over a ``torch.distributed`` group.
"""

from .sharding import (  # noqa: F401
    CEP_AXIS,
    DEFAULT_RULES,
    CepMesh,
    MeshRules,
    PartitionSpec,
    cep_mesh,
    current_rules,
    fleet_pspec,
    logical_constraint,
    logical_sharding,
    resolve_cep_mesh,
    set_rules,
    shard_fleet_fn,
    shard_fleet_scan,
    shard_map,
    use_rules,
)
