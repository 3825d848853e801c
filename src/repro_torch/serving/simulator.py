"""Plan routing shared by the executor and, later, the simulator.

Only ``_routing`` is here so far; the discrete-event simulator comes
with the server.
"""
from __future__ import annotations

from repro_torch.core.planner import ExecutionPlan
from repro_torch.core.repartition import GroupPlan, StagePlan


def _routing(plan: ExecutionPlan) -> dict:
    """client name -> list of (StagePlan, shared StagePlan) stage chains."""
    routes: dict[str, list[StagePlan]] = {}

    def clients_of(frag):
        if frag.merged_from:
            out = []
            for sub in frag.merged_from:
                out += clients_of(sub)
            return out
        return [frag.client]

    for pl in plan.plans:
        if isinstance(pl, GroupPlan):
            for a in pl.aligns:
                for c in clients_of(a.fragment):
                    routes[c] = [a, pl.shared] if a.end > a.start \
                        else [pl.shared]
        else:
            for c in clients_of(pl.stage.fragment):
                routes[c] = [pl.stage]
    return routes
