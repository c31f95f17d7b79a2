"""Autotune: close the loop between the analytic comm-cost stack and the
hardware (PyTorch port of ``repro/autotune``).

``probe`` measures real grouped reductions on the card (or the CPU, or
the ranks of a world); ``calibrate`` fits
:class:`repro_torch.core.theory.CommModel` from the samples and
serializes the reference's JSON calibration artifact
(``$REPRO_CALIBRATION`` / ``resolve_calibration`` let the analytic
roofline cost with it instead of its built-in constants);
``controller.CostAwarePlan`` adapts every reduction period from the
calibrated per-level cost ratios plus the loss ladder; ``search``
enumerates and ranks whole plans (periods x reducers per level) by
calibrated wall-clock x the Thm-3.4 convergence objective, exposed as
``--autotune`` on launch/train.py.
"""
from repro_torch.autotune.calibrate import (  # noqa: F401
    CPU_MEDIAN_REL_ERR, Calibration, calibrate_file, fit_comm_model,
    predict_seconds, resolve_calibration, resolve_comm_model)
from repro_torch.autotune.controller import CostAwarePlan  # noqa: F401
from repro_torch.autotune.probe import (ProbePoint,  # noqa: F401
                                        default_grid, load_samples,
                                        measure_point, run_probe)
from repro_torch.autotune.search import (ScoredPlan,  # noqa: F401
                                         SearchSpace, enumerate_specs,
                                         recommend_plan, search_plans)
