"""Instance placement: pack fragment instances (chip-share %) onto chips.

The MPS co-location of the paper: every instance claims ``share`` % of
one chip; instances are packed first-fit-decreasing, capped at 100 % per
chip (the paper caps concurrent MPS shares at 100 % to bound interference,
§5.1 — same rule here). Reports chips used, the bin-packing view of the
``total_resource`` metric.

Beyond the one-shot packing, this module is placement-aware about
*replans*: :func:`migrate` takes the previous placement plus a
``core.plandiff`` diff and produces the new placement as a list of
chip-level :class:`MigrationAction`s — spawn, retire, move — such that
instances untouched by the replan **stay on their chips**. A replan that
resizes one pool therefore costs a handful of instance spawns/moves
instead of the full re-pack ``place`` would do from scratch; the serving
executor applies the actions live (``GraftExecutor.apply_plan``) so warm
instances never hop chips just because the bin-packer re-sorted.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.plandiff import ADD, PlanDiff, REBATCH, REMOVE, RESIZE

SPAWN = "spawn"      # bring a new instance up on `chip`
RETIRE = "retire"    # take an instance down, freeing `chip` capacity
MOVE = "move"        # relocate a live instance `from_chip` -> `chip`


@dataclass
class Chip:
    index: int
    used: int = 0
    instances: list = field(default_factory=list)

    @property
    def free(self) -> int:
        return 100 - self.used


@dataclass(frozen=True)
class MigrationAction:
    """One chip-level step of a placement transition."""
    kind: str                       # spawn | retire | move
    key: tuple                      # pool identity (model, start, end)
    instance: int                   # ordinal within the pool
    chip: int                       # destination (spawn/move) / vacated (retire)
    from_chip: Optional[int] = None  # move only: the chip being vacated


@dataclass
class Placement:
    chips: list
    # (pool key, instance ordinal) -> chip index; empty for placements
    # built by legacy callers that only need the bin-packing totals
    assignments: dict = field(default_factory=dict)

    @property
    def n_chips(self) -> int:
        return len(self.chips)

    @property
    def utilization(self) -> float:
        if not self.chips:
            return 0.0
        return sum(c.used for c in self.chips) / (100.0 * len(self.chips))

    def chips_of(self, key: tuple) -> list:
        """Chip index per instance ordinal of pool ``key`` (ordinal order)."""
        pairs = [(i, chip) for (k, i), chip in self.assignments.items()
                 if k == key]
        return [chip for _, chip in sorted(pairs)]


def place(plan, *, chip_capacity: int = 100) -> Placement:
    """plan: ExecutionPlan. Returns the chip packing (scratch, FFD)."""
    items = []
    for model, start, end, alloc in plan.instances:
        for i in range(alloc.n_instances):
            items.append((int(alloc.share), f"{model}[{start}:{end})#{i}"))
    items.sort(reverse=True)
    chips: list[Chip] = []
    for share, tag in items:
        share = min(share, chip_capacity)
        for c in chips:
            if c.free >= share:
                c.used += share
                c.instances.append((tag, share))
                break
        else:
            c = Chip(index=len(chips), used=share, instances=[(tag, share)])
            chips.append(c)
    return Placement(chips=chips)


# ---------------------------------------------------------------------------
# incremental, identity-keyed placement (the serving executor's view)
# ---------------------------------------------------------------------------

def place_pools(pools: dict, *, chip_capacity: int = 100) -> Placement:
    """Initial packing of a pool table ({PoolKey: PoolSpec}, the
    ``core.plandiff`` identity space): first-fit-decreasing, with every
    instance tracked in ``assignments`` so later replans can
    :func:`migrate` instead of re-packing."""
    items = []       # (share, key, ordinal) — FFD with a deterministic tie order
    for key in sorted(pools):
        spec = pools[key]
        for i in range(spec.n_instances):
            items.append((min(int(spec.share), chip_capacity), key, i))
    items.sort(key=lambda t: (-t[0], t[1], t[2]))
    used: dict[int, int] = {}
    assignments: dict = {}
    for share, key, i in items:
        chip = _first_fit(used, share, chip_capacity)
        used[chip] = used.get(chip, 0) + share
        assignments[(key, i)] = chip
    return _build(used, assignments, pools, chip_capacity)


def _first_fit(used: dict, share: int, cap: int) -> int:
    for c in sorted(used):
        if cap - used[c] >= share:
            return c
    return max(used, default=-1) + 1


def _build(used: dict, assignments: dict, pools: dict,
           chip_capacity: int = 100) -> Placement:
    chips = []
    by_chip: dict[int, list] = {}
    for (key, i), chip in assignments.items():
        model, start, end = key[:3]
        role = f"@{key[3]}" if len(key) > 3 else ""
        share = min(int(pools[key].share), chip_capacity)
        by_chip.setdefault(chip, []).append(
            (f"{model}[{start}:{end}){role}#{i}", share))
    for c in sorted(by_chip):
        insts = sorted(by_chip[c])
        chips.append(Chip(index=c, used=sum(s for _, s in insts),
                          instances=insts))
    return Placement(chips=chips, assignments=dict(assignments))


def migrate(prev: Placement, diff: PlanDiff, *,
            chip_capacity: int = 100) -> tuple:
    """Transition ``prev`` across ``diff`` -> (new Placement, [MigrationAction]).

    Invariant (the point of this function): an instance whose pool is
    kept — or merely resized/rebatched without its own ordinal or share
    being affected — keeps its chip. Only three things emit actions:

      * instances of removed pools / shrunk ordinals -> ``retire``;
      * instances whose share grew past their chip's free capacity
        (rebatch) -> ``move`` to the first chip that fits;
      * new pools / grown ordinals -> ``spawn`` into existing free
        capacity first (first-fit), new chips only when nothing fits.
    """
    assignments = dict(prev.assignments)
    old_share = {a.key: a.old.share for a in diff.actions if a.old}
    new_pools = {a.key: a.new for a in diff.actions if a.new is not None}
    used: dict[int, int] = {}
    for (key, i), chip in assignments.items():
        used[chip] = used.get(chip, 0) + min(
            int(old_share.get(key, 0)), chip_capacity)
    actions: list[MigrationAction] = []

    # 1) retire: removed pools and shrunk ordinals free capacity first
    for a in diff.actions:
        if a.kind == REMOVE:
            keep_n = 0
        elif a.kind in (RESIZE, REBATCH):
            keep_n = a.new.n_instances
        else:
            continue
        n_old = a.old.n_instances if a.old else 0
        for i in range(keep_n, n_old):
            chip = assignments.pop((a.key, i), None)
            if chip is None:
                continue
            used[chip] -= min(int(a.old.share), chip_capacity)
            actions.append(MigrationAction(RETIRE, a.key, i, chip=chip))

    # 2) re-share: a rebatch that grew the share may overflow the chip —
    #    grow in place when it fits, move (never re-pack) when it doesn't
    for a in diff.by_kind(REBATCH):
        o_share = min(int(a.old.share), chip_capacity)
        n_share = min(int(a.new.share), chip_capacity)
        if o_share == n_share:
            continue
        for i in range(min(a.old.n_instances, a.new.n_instances)):
            chip = assignments.get((a.key, i))
            if chip is None:
                continue
            if used[chip] - o_share + n_share <= chip_capacity:
                used[chip] += n_share - o_share          # grow/shrink in place
                continue
            used[chip] -= o_share
            dst = _first_fit(used, n_share, chip_capacity)
            used[dst] = used.get(dst, 0) + n_share
            assignments[(a.key, i)] = dst
            actions.append(MigrationAction(MOVE, a.key, i, chip=dst,
                                           from_chip=chip))

    # 3) spawn: anything the new plan wants that has no chip yet
    for key in sorted(new_pools):
        spec = new_pools[key]
        share = min(int(spec.share), chip_capacity)
        for i in range(spec.n_instances):
            if (key, i) in assignments:
                continue
            dst = _first_fit(used, share, chip_capacity)
            used[dst] = used.get(dst, 0) + share
            assignments[(key, i)] = dst
            actions.append(MigrationAction(SPAWN, key, i, chip=dst))

    return _build(used, assignments, new_pools, chip_capacity), actions
