"""Distribution substrate of the port: the CEP fleet's device mesh.

The CEP half of ``repro.distributed``: the ``cep`` mesh axis and the one
split rule of the K-partition data plane.  The logical-axis rules of the
LM stack (``MeshRules``, ``use_rules``, ``logical_constraint``) and the
gradient collectives come with the LM slices (ROADMAP.md).
"""

from .sharding import (  # noqa: F401
    CEP_AXIS,
    CepMesh,
    cep_mesh,
    fleet_pspec,
    resolve_cep_mesh,
    shard_fleet_fn,
    shard_fleet_scan,
    shard_map,
)
