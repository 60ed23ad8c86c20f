"""Motion planning (port of ``reak_tpu.planning``): so far the queries and
results of ``planning/queries.py``.  The planners, workspaces and engines
are not ported yet."""
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult, path_cost

__all__ = ["PlanningQuery", "PlanResult", "path_cost"]
