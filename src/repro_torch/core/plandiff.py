"""Plan diffing — the delta between two ExecutionPlans, as pool actions.

Online serving (``serving.controller``) replans continuously; tearing the
whole deployment down on every replan would lose warm state (jitted
fragment programs, queued requests, instance start-up) exactly when the
system is under churn. This module computes the *minimal* set of pool
mutations between two plans so unchanged pools survive a replan intact.

Identity: an instance pool is keyed by ``(model, start, end)`` — the
fragment block range it serves. Two stage plans with the same key are the
same pool for diffing purposes (their instance counts aggregate; see
:func:`plan_pools`). Between an old and a new plan, each key yields one
action:

  * ``keep``    — identical (share, batch, n_instances, role): no-op.
  * ``resize``  — only the instance count changed: scale the live pool.
  * ``rebatch`` — batch size, resource share and/or role changed:
                  re-configure the pool in place (block range — hence any
                  compiled program — is unchanged).
  * ``add`` / ``remove`` — pool exists on only one side.

Prefill/decode disaggregation rides the same identity scheme: a pool
spec carries a ``role`` (``"both"`` — the default, serves everything;
``"prefill"`` — one-shot traffic and prompt prefill, never a resident
decode stream; ``"decode"`` — resident decode streams only, fed KV
blocks over the transport). A decode-role pool gets a role-qualified
key ``(model, start, end, "decode")`` (:func:`decode_pool_key`) so it
can coexist with the prefill pool covering the same block range —
``pool_range(key)`` recovers the plain ``(model, start, end)`` triple
either way. Plans annotate roles via ``ExecutionPlan.meta``
(``pool_roles``: key -> role; ``extra_pools``: PoolSpecs with no stage
plan of their own, i.e. the decode pools), which :func:`plan_pools`
folds in — so a disaggregation rollout or rollback is an ordinary plan
diff (add/remove of the decode pool, rebatch of the re-roled prefill
pool) applied live like any other replan.

``apply_diff(pools(old), diff) == pools(new)`` exactly — the diff is a
complete, invertible description of the transition (tested in
tests/test_controller.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

PoolKey = tuple  # (model, start, end) or (model, start, end, role)

#: legal pool roles, in "serves the most" -> "serves the least" order
POOL_ROLES = ("both", "prefill", "decode")


def pool_range(key: PoolKey) -> tuple:
    """The ``(model, start, end)`` triple of a (possibly role-qualified)
    pool key."""
    return tuple(key[:3])


def decode_pool_key(model: str, start: int, end: int) -> PoolKey:
    """The role-qualified key of a decode-role pool over ``[start,
    end)``. Decode pools are the only role that qualifies the key: at
    most one prefill/both pool may cover a range (they are the same
    deployable thing), but a decode pool must coexist with the prefill
    pool feeding it KV blocks over the same range."""
    return (model, int(start), int(end), "decode")


KEEP = "keep"
ADD = "add"
REMOVE = "remove"
RESIZE = "resize"
REBATCH = "rebatch"


@dataclass(frozen=True)
class PoolSpec:
    """The deployable shape of one instance pool."""
    key: PoolKey
    share: int
    batch: int
    n_instances: int
    role: str = "both"               # both | prefill | decode

    def __post_init__(self):
        if self.role not in POOL_ROLES:
            raise ValueError(f"unknown pool role {self.role!r} "
                             f"(expected one of {POOL_ROLES})")

    @property
    def model(self) -> str:
        return self.key[0]

    @property
    def start(self) -> int:
        return self.key[1]

    @property
    def end(self) -> int:
        return self.key[2]

    @property
    def resource(self) -> float:
        return self.share * self.n_instances


@dataclass(frozen=True)
class PoolAction:
    kind: str                             # keep|add|remove|resize|rebatch
    key: PoolKey
    old: Optional[PoolSpec] = None
    new: Optional[PoolSpec] = None

    @property
    def n_delta(self) -> int:
        """Instance-count change this action implies (what placement-aware
        autoscaling spawns/retires instead of re-packing)."""
        return ((self.new.n_instances if self.new else 0)
                - (self.old.n_instances if self.old else 0))


@dataclass
class PlanDiff:
    actions: list = field(default_factory=list)

    def by_kind(self, kind: str) -> list:
        return [a for a in self.actions if a.kind == kind]

    @property
    def is_identity(self) -> bool:
        return all(a.kind == KEEP for a in self.actions)

    @property
    def n_kept(self) -> int:
        """Pools surviving the transition (keep/resize/rebatch)."""
        return sum(a.kind in (KEEP, RESIZE, REBATCH) for a in self.actions)

    def summary(self) -> dict:
        out = {k: 0 for k in (KEEP, ADD, REMOVE, RESIZE, REBATCH)}
        for a in self.actions:
            out[a.kind] += 1
        return out


def plan_pools(plan) -> dict:
    """``ExecutionPlan`` (or an iterable of GroupPlan|SoloPlan) ->
    {PoolKey: PoolSpec}.

    Stage plans sharing a key aggregate into one pool: instance counts
    sum, and (share, batch) come from the largest-resource member — the
    runtime serves the merged queue with one homogeneous configuration
    (a deliberate approximation; distinct-key pools are exact).

    An ``ExecutionPlan`` carrying disaggregation metadata contributes
    two more things: ``meta["pool_roles"]`` re-roles derived pools
    (e.g. the full-range pool becomes ``"prefill"``), and
    ``meta["extra_pools"]`` appends PoolSpecs that have no stage plan —
    the decode-role pools fed purely over the KV handoff.
    """
    import dataclasses as _dc
    plans = getattr(plan, "plans", plan)
    members: dict[PoolKey, list] = {}
    for pl in plans:
        for key, sp in pl.pools():
            members.setdefault(key, []).append(sp)
    out = {}
    for key, sps in members.items():
        lead = max(sps, key=lambda s: (s.alloc.resource, s.alloc.share,
                                       s.alloc.batch))
        out[key] = PoolSpec(key=key, share=lead.alloc.share,
                            batch=lead.alloc.batch,
                            n_instances=sum(s.alloc.n_instances for s in sps))
    meta = getattr(plan, "meta", None) or {}
    for key, role in meta.get("pool_roles", {}).items():
        key = tuple(key)
        if key in out and out[key].role != role:
            out[key] = _dc.replace(out[key], role=role)
    for sp in meta.get("extra_pools", ()):
        if sp.key in out:
            raise ValueError(f"extra pool {sp.key} collides with a "
                             "stage-plan pool of the same key")
        out[sp.key] = sp
    return out


def diff_plans(old, new) -> PlanDiff:
    """Diff two plans (or pool tables from :func:`plan_pools`)."""
    old_pools = old if isinstance(old, dict) else plan_pools(old)
    new_pools = new if isinstance(new, dict) else plan_pools(new)
    actions = []
    for key in sorted(set(old_pools) | set(new_pools)):
        o, n = old_pools.get(key), new_pools.get(key)
        if o is None:
            actions.append(PoolAction(ADD, key, new=n))
        elif n is None:
            actions.append(PoolAction(REMOVE, key, old=o))
        elif o == n:
            actions.append(PoolAction(KEEP, key, old=o, new=n))
        elif (o.share, o.batch, o.role) == (n.share, n.batch, n.role):
            actions.append(PoolAction(RESIZE, key, old=o, new=n))
        else:
            actions.append(PoolAction(REBATCH, key, old=o, new=n))
    return PlanDiff(actions=actions)


def apply_diff(old_pools: dict, diff: PlanDiff) -> dict:
    """Apply ``diff`` to a pool table; reproduces the new plan's pools."""
    out = dict(old_pools)
    for a in diff.actions:
        if a.kind == REMOVE:
            out.pop(a.key, None)
        elif a.kind in (ADD, RESIZE, REBATCH):
            out[a.key] = a.new
        # KEEP: nothing
    return out
