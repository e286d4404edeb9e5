"""Core MOO library: the paper's contribution (Progressive Frontier + MOGD).

Public API::

    from repro_torch.core import (
        TaskSpec, Objective,                      # declarative front door
        UtopiaNearest, WeightedUtopiaNearest, WorkloadAware,
        MOOProblem, continuous, integer, categorical, boolean,
        MOGDConfig, MOGDSolver,
        ProgressiveFrontier, solve_pf,
        utopia_nearest, weighted_utopia_nearest,
        pareto_mask, pareto_filter, hypervolume,
    )

Describe tuning tasks with :class:`TaskSpec` and let ``TaskSpec.compile()``
build the :class:`MOOProblem`.  Entry points take ``device=None``, which
means ``cuda``; pass ``device="cpu"`` to run on the host.
"""

from .frontier_store import FrontierStore
from .hyperrectangle import (
    Rectangle,
    RectangleQueue,
    compute_bounds,
    grid_cells,
    make_rectangle,
    split_rectangle,
)
from .mogd import (
    COResult,
    MOGDConfig,
    MOGDSolver,
    estimate_objective_bounds,
    grid_reference_solve,
    single_objective_box,
    solve_grouped,
)
from .pareto import (
    coverage_spread,
    crowding_distance,
    dominates,
    hypervolume,
    hypervolume_2d,
    pareto_filter,
    pareto_filter_masked,
    pareto_mask,
)
from .problem import (
    MOOProblem,
    SpaceEncoder,
    VariableSpec,
    boolean,
    bound_scales,
    categorical,
    continuous,
    feasible_mask,
    integer,
)
from .progressive_frontier import (
    PFResult,
    PFState,
    PopInfo,
    ProgressiveFrontier,
    coalesce_step,
    export_pf_state,
    frontier_hypervolume,
    import_pf_state,
    live_seed_points,
    solve_pf,
)
from .recommend import (
    WorkloadClassWeights,
    classify_workload,
    select,
    utopia_nearest,
    weighted_single_objective_pick,
    weighted_utopia_nearest,
    workload_aware_wun,
)
from .synthetic import (
    make_dtlz2,
    make_mixed_problem,
    make_sphere2,
    make_zdt1,
    mlp_surrogate_task,
    sphere2_task,
    zdt1_task,
)
from .task import (
    Objective,
    Preference,
    TaskSpec,
    UtopiaNearest,
    WeightedUtopiaNearest,
    WorkloadAware,
    as_problem,
    preference_from_legacy,
)

__all__ = [
    "COResult", "FrontierStore", "MOGDConfig", "MOGDSolver", "MOOProblem",
    "Objective", "PFResult", "PFState", "PopInfo", "Preference",
    "ProgressiveFrontier", "Rectangle", "RectangleQueue", "SpaceEncoder",
    "TaskSpec", "UtopiaNearest", "VariableSpec", "WeightedUtopiaNearest",
    "WorkloadAware", "WorkloadClassWeights", "as_problem", "boolean",
    "bound_scales", "categorical", "classify_workload", "coalesce_step",
    "compute_bounds", "continuous", "coverage_spread", "crowding_distance",
    "dominates", "estimate_objective_bounds", "export_pf_state",
    "feasible_mask", "frontier_hypervolume", "grid_cells",
    "grid_reference_solve", "hypervolume", "hypervolume_2d",
    "import_pf_state", "integer", "live_seed_points", "make_dtlz2",
    "make_mixed_problem", "make_rectangle", "make_sphere2", "make_zdt1",
    "mlp_surrogate_task", "pareto_filter", "pareto_filter_masked",
    "pareto_mask", "preference_from_legacy", "select",
    "single_objective_box", "solve_grouped", "solve_pf", "sphere2_task",
    "split_rectangle", "utopia_nearest", "weighted_single_objective_pick",
    "weighted_utopia_nearest", "workload_aware_wun", "zdt1_task",
]
