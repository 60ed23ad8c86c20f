"""Sampling-based motion planning with device-batched evaluation (port of
``reak_tpu.planning``).

(ref: ctrl/graph_alg/rr_tree.hpp:179, rrt_star.hpp:530,
probabilistic_roadmap.hpp:309, sbastar_search.hpp:869,
ctrl/path_planning/rrt_path_planner.hpp:64, metric_space_search.hpp:172
dvp_tree, planner_exec_engines.hpp:86-324).

Tree bookkeeping stays on the host where it is pointer-heavy, while the
expensive work runs on the device in large batches — K samples per
iteration, K nearest-neighbor searches against the whole vertex set (one
masked distance matrix), K steer/collision evaluations.  Every random draw
goes through a draw object (``planning/draws.py``): a planner's ``seed`` is
an int, a ``torch.Generator`` or a draw object.
"""
from reak_tpu_torch.planning.workspace import (
    Workspace,
    NoObstacleWorkspace,
    ChainWorkspace,
    bitmap_workspace,
)
from reak_tpu_torch.planning.rrt import rrt_plan, birrt_plan
from reak_tpu_torch.planning.rrt_star import rrt_star_plan
from reak_tpu_torch.planning.prm import prm_plan
from reak_tpu_torch.planning.sbastar import sbastar_plan
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult, path_cost
from reak_tpu_torch.planning.engines import monte_carlo_engine
from reak_tpu_torch.planning.adstar import ADStar, adstar_search
from reak_tpu_torch.planning.fadprm import FADPRMPlanner, fadprm_plan
from reak_tpu_torch.planning.rrg import rrg_plan
from reak_tpu_torch.planning.dvp_tree import DVPTree, linear_nn
from reak_tpu_torch.planning.intercept import (InterceptQuery, intercept_plan,
                                               RendezvousQuery,
                                               intercept_plan_1st_order)
from reak_tpu_torch.planning.sbastar_rrtstar import sbastar_rrtstar_plan
from reak_tpu_torch.planning.lazy_prm import lazy_prm_plan, bnb_prune
from reak_tpu_torch.planning.reach_sort import ReachabilitySortedSet

__all__ = [
    "ADStar",
    "adstar_search",
    "FADPRMPlanner",
    "fadprm_plan",
    "rrg_plan",
    "DVPTree",
    "linear_nn",
    "InterceptQuery",
    "intercept_plan",
    "RendezvousQuery",
    "intercept_plan_1st_order",
    "Workspace",
    "NoObstacleWorkspace",
    "ChainWorkspace",
    "rrt_plan",
    "birrt_plan",
    "rrt_star_plan",
    "prm_plan",
    "sbastar_plan",
    "PlanningQuery",
    "PlanResult",
    "path_cost",
    "monte_carlo_engine",
]
