"""Hier-AVG core of the port: topology, reduction plans, the round and
step builders, the baselines and the single-device simulator."""
from repro_torch.core.topology import (HierTopology, global_average,  # noqa: F401
                                       local_average, pod_average, stack_like,
                                       unstack_first, where_active)
from repro_torch.core.plan import (ReductionLevel, ReductionPlan,  # noqa: F401
                                   resolve_plan)
from repro_torch.core.hier_avg import (TrainState, init_state,  # noqa: F401
                                       make_hier_round, make_hier_step,
                                       make_sgd_step, stacked_grad_fn)
from repro_torch.core.baselines import (make_kavg_round,  # noqa: F401
                                        make_sync_sgd_round)
from repro_torch.core.schedules import (AdaptiveK2,  # noqa: F401
                                        AdaptivePlan, thm31_gamma, thm31_k2)
from repro_torch.core.simulator import SimResult, Simulator  # noqa: F401
