"""Heterogeneous workload scheduler, a copy of
``fedml_tpu/schedule/scheduler.py``.

Reference: fedml_core/distributed/schedule/scheduler.py — branch-and-bound /
DP assignment of per-client workloads to compute resources under memory
constraints (``scheduler``:3, ``DP_schedule``:109, ``assign_a_workload``:13,54)
— used for silo/GPU packing experiments.

Framing: workloads = per-client costs (sample counts × model FLOPs),
resources = chips/hosts with HBM budgets. Greedy-LPT (longest processing time)
and the DP optimal makespan split are provided; LPT is the one the cohort
stager can use to balance multi-client-per-chip packing.
"""

from __future__ import annotations

import numpy as np


def lpt_schedule(workloads: np.ndarray, n_resources: int,
                 capacities: np.ndarray | None = None) -> list[list[int]]:
    """Longest-processing-time greedy: sort desc, place each on the least-
    loaded resource with remaining capacity. Returns resource -> workload idxs.
    """
    workloads = np.asarray(workloads, dtype=np.float64)
    caps = (
        np.full(n_resources, np.inf)
        if capacities is None
        else np.asarray(capacities, dtype=np.float64)
    )
    loads = np.zeros(n_resources)
    used = np.zeros(n_resources)
    assignment: list[list[int]] = [[] for _ in range(n_resources)]
    for idx in np.argsort(-workloads):
        order = np.argsort(loads)
        for r in order:
            if used[r] + workloads[idx] <= caps[r]:
                assignment[r].append(int(idx))
                loads[r] += workloads[idx]
                used[r] += workloads[idx]
                break
        else:
            raise ValueError("workload does not fit any resource capacity")
    return assignment


def dp_schedule(workloads: np.ndarray, n_resources: int, max_items: int = 20) -> tuple[list[list[int]], float]:
    """Optimal makespan assignment by DP over subsets (reference
    DP_schedule:109 — exact for small instances). Exponential in the number
    of workloads; guarded by ``max_items``. Returns (assignment, makespan)."""
    w = np.asarray(workloads, dtype=np.float64)
    n = len(w)
    if n > max_items:
        raise ValueError(f"DP schedule is exact/exponential; {n} > {max_items} items")
    subset_sum = np.zeros(1 << n)
    for mask in range(1 << n):
        s = 0.0
        m = mask
        i = 0
        while m:
            if m & 1:
                s += w[i]
            m >>= 1
            i += 1
        subset_sum[mask] = s

    full = (1 << n) - 1
    INF = float("inf")
    best = np.full((n_resources + 1, 1 << n), INF)
    choice = np.zeros((n_resources + 1, 1 << n), dtype=np.int64)
    best[0, 0] = 0.0
    for r in range(1, n_resources + 1):
        for mask in range(1 << n):
            sub = mask
            while True:
                if best[r - 1, mask ^ sub] < INF:
                    cand = max(best[r - 1, mask ^ sub], subset_sum[sub])
                    if cand < best[r, mask]:
                        best[r, mask] = cand
                        choice[r, mask] = sub
                if sub == 0:
                    break
                sub = (sub - 1) & mask

    assignment: list[list[int]] = []
    mask = full
    for r in range(n_resources, 0, -1):
        sub = int(choice[r, mask])
        assignment.append([i for i in range(n) if sub >> i & 1])
        mask ^= sub
    assignment.reverse()
    return assignment, float(best[n_resources, full])


def balance_cohort_packing(client_sizes: np.ndarray, n_slots: int) -> list[list[int]]:
    """Pack cohort clients into device slots minimizing the max per-slot
    sample count — the multi-client-per-chip layout for small slices
    (SURVEY §7 'non-divisible client counts vs. device mesh')."""
    return lpt_schedule(client_sizes, n_slots)
