"""Elastic membership for Hier-AVG fleets (PyTorch port of
``repro/elastic``).

Three legs, one thesis — learners run decoupled between reductions, so a
learner that misses a fire should cost the round nothing:

  * participation-masked reductions — the ``mask=`` / ``active=`` plumbing
    in core/topology.py + core/hier_avg.py (absent learners contribute
    weight 0; EF/params untouched across a missed fire);
  * deterministic fault injection — :class:`FaultSchedule`, a pure
    function of (seed, unit, round), driving masks through the Simulator
    and ``launch/train.py --faults``;
  * checkpointed fleet reshape — :func:`reshape_state` /
    :func:`elastic_restore`, resuming onto a different learner count with
    survivors bit-preserved and un-remappable reducer state dropped
    loudly (:class:`CommStateDropWarning`).

Expected-cost billing for unreliable tiers lives in core/theory.py
(``effective_participants``, ``plan_comm_per_round(..., drop_prob=)``).
"""
from repro_torch.elastic.faults import (FaultClause, FaultSchedule,
                                        level_deadlines, parse_faults)
from repro_torch.elastic.reshape import (CommStateDropWarning,
                                         checkpoint_topology,
                                         elastic_restore, learner_index_map,
                                         reshape_comm_state, reshape_state,
                                         save_elastic_checkpoint)

__all__ = [
    "CommStateDropWarning",
    "FaultClause",
    "FaultSchedule",
    "checkpoint_topology",
    "elastic_restore",
    "learner_index_map",
    "level_deadlines",
    "parse_faults",
    "reshape_comm_state",
    "reshape_state",
    "save_elastic_checkpoint",
]
