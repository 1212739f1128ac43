"""Logical-axis sharding rules and their DTensor placements (port of the
reference's ``sharding/``)."""

from repro_torch.sharding.rules import (
    AxisRules,
    DEFAULT_RULES,
    DP_ONLY_RULES,
    FSDP_RULES,
    MeshShape,
    NAMED_RULES,
    local_shape,
    logical_to_spec,
    mesh_axis_sizes,
    param_specs,
    spec_to_placements,
)

__all__ = ["AxisRules", "DEFAULT_RULES", "DP_ONLY_RULES", "FSDP_RULES",
           "MeshShape", "NAMED_RULES", "local_shape", "logical_to_spec",
           "mesh_axis_sizes", "param_specs", "spec_to_placements"]
