"""Graft's contribution: DNN re-alignment scheduling for hybrid DL."""
from repro_torch.core.costmodel import LayerCosts, arch_layer_costs
from repro_torch.core.fragment import Fragment, merge_fragments
from repro_torch.core.profiles import (PerfProfile, ProfileBook, Allocation,
                                       default_book)
from repro_torch.core.merging import merge
from repro_torch.core.grouping import group_fragments
from repro_torch.core.repartition import (realign, GroupPlan, SoloPlan,
                                          solo_plan, pool_key)
from repro_torch.core.planner import GraftPlanner, ExecutionPlan
from repro_torch.core.plandiff import (PoolSpec, PoolAction, PlanDiff,
                                       plan_pools, diff_plans, apply_diff)
from repro_torch.core.baselines import plan_gslice, plan_static, plan_optimal
from repro_torch.core.placement import (place, place_pools, migrate,
                                        Placement, MigrationAction)

__all__ = [
    "LayerCosts", "arch_layer_costs", "Fragment", "merge_fragments",
    "PerfProfile", "ProfileBook", "Allocation", "default_book",
    "merge", "group_fragments", "realign", "GroupPlan", "SoloPlan",
    "solo_plan", "pool_key", "GraftPlanner", "ExecutionPlan",
    "PoolSpec", "PoolAction", "PlanDiff", "plan_pools", "diff_plans",
    "apply_diff",
    "plan_gslice", "plan_static", "plan_optimal", "place", "place_pools",
    "migrate", "Placement", "MigrationAction",
]
