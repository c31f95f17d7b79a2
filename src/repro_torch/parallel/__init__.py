"""Placement of the port's learners on ``torch.distributed`` ranks: the
partition rules and the rank mesh (sharding.py), and the one module that
calls the collectives (collectives.py)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES, PartitionRules, PartitionSpec, PSpecDropWarning,
    RankMesh, ShardPlan, batch_pspec, make_constraint_fn, param_pspecs,
    replica_groups, resolve_pspec, safe_pspec, shard_plan)
