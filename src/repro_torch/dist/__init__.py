"""repro_torch.dist: the device-mesh sharding layer (``repro/dist``).

``repro_torch.dist.sharding`` holds the logical-axis rules, the spec logic
that the reference's layouts come from, and the collectives the port's
models call on the mesh.
"""
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (Mesh, P, Rules, Spec, attention_scheme,
                                       axis_rules, current_rules, named,
                                       param_pspecs, production_rules_table,
                                       shard, shard_spec)

__all__ = [
    "sharding", "Mesh", "P", "Rules", "Spec", "attention_scheme",
    "axis_rules", "current_rules", "named", "param_pspecs",
    "production_rules_table", "shard", "shard_spec",
]
