"""DNN fragments grouping (paper §4.2).

The grouping problem is cast as a variant of balanced graph partitioning:
fragments are nodes of a complete graph, edge weights are weighted
Euclidean distances over the property vectors (p, t, q); we want K
equal-sized subsets minimising

    sum_k sum_{e in E_k} (w_e - mean_k)^2 / |E_k|            (intra variance)
  + sum_k sum_{e in E'_k} w_e                                 (cut weight)

solved with the paper's Fennel-style greedy: seed K groups, stream the
remaining fragments, assign each to the group with the least objective
increase (groups capped at the target size).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.fragment import Fragment, normalization_scales


def _pairwise_dist(frags: list[Fragment],
                   weights: tuple[float, float, float]) -> np.ndarray:
    """Edge weights per §4.2: similarity derived from the weighted Euclidean
    distance over (p, t, q). The paper states weights encode *similarity*
    (maximise intra, minimise cut), so we use w = 1 / (1 + dist)."""
    v = np.stack([f.vec() for f in frags])
    v = v / normalization_scales(frags) * np.asarray(weights, np.float64)
    d = v[:, None, :] - v[None, :, :]
    dist = np.sqrt(np.sum(d * d, axis=-1))
    return 1.0 / (1.0 + dist)


def _objective(groups: list[list[int]], D: np.ndarray) -> float:
    total = 0.0
    assigned = [i for g in groups for i in g]
    for g in groups:
        if len(g) >= 2:
            idx = np.array(g)
            w = D[np.ix_(idx, idx)][np.triu_indices(len(g), 1)]
            total += float(np.var(w))
        others = [i for i in assigned if i not in g]
        if others and g:
            total += float(D[np.ix_(np.array(g), np.array(others))].sum()) / 2
    return total


def group_fragments(frags: list[Fragment], *, group_size: int = 5,
                    weights: tuple[float, float, float] = (1.0, 1.0, 1.0),
                    seed: int = 0) -> list[list[Fragment]]:
    """Greedy balanced grouping. Returns a list of fragment groups."""
    n = len(frags)
    if n == 0:
        return []
    if n <= group_size:
        return [list(frags)]
    K = -(-n // group_size)
    D = _pairwise_dist(frags, weights)
    rng = np.random.RandomState(seed)
    # farthest-point seeding (k-means++-style): spreads seeds across the
    # property space — strictly better than the paper's random seed pick
    # and deterministic (documented deviation, DESIGN.md §2)
    first = int(rng.randint(n))
    seeds = [first]
    while len(seeds) < K:
        smax = D[:, seeds].max(axis=1)          # D holds similarities
        smax[seeds] = np.inf
        seeds.append(int(np.argmin(smax)))      # least similar to any seed
    rest = [i for i in rng.permutation(n) if i not in set(seeds)]
    groups: list[list[int]] = [[s] for s in seeds]

    assigned = list(seeds)
    for x in rest:
        best, best_cost = None, np.inf
        for k, g in enumerate(groups):
            if len(g) >= group_size:
                continue
            # delta objective of adding x to group k
            gi = np.array(g)
            new_edges = D[x, gi]
            all_edges = np.concatenate([
                D[np.ix_(gi, gi)][np.triu_indices(len(g), 1)], new_edges]) \
                if len(g) > 1 else new_edges
            var_term = float(np.var(all_edges))
            old_var = float(np.var(
                D[np.ix_(gi, gi)][np.triu_indices(len(g), 1)])) \
                if len(g) > 1 else 0.0
            ext = float(D[x, np.array(assigned)].sum() - new_edges.sum())
            cost = (var_term - old_var) + ext
            if cost < best_cost:
                best, best_cost = k, cost
        groups[best].append(x)
        assigned.append(x)
    return [[frags[i] for i in g] for g in groups]


def optimal_groupings(n: int, max_size: int):
    """All set partitions of range(n) into blocks of size <= max_size
    (the Optimal baseline's enumeration; exponential — guard n)."""
    def rec(items):
        if not items:
            yield []
            return
        first, rest = items[0], items[1:]
        from itertools import combinations
        for k in range(0, min(max_size - 1, len(rest)) + 1):
            for combo in combinations(rest, k):
                block = [first, *combo]
                remaining = [i for i in rest if i not in combo]
                for sub in rec(remaining):
                    yield [block] + sub
    yield from rec(list(range(n)))
