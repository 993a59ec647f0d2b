"""Hierarchical (two-level) FedAvg, the port of
``fedml_tpu/algorithms/hierarchical.py``: clients -> groups -> global.

Reference: fedml_api/standalone/hierarchical_fl/: random group assignment
(trainer.py:10-30), nested loops global_comm_round x group_comm_round x
epochs with epoch-aligned aggregation (trainer.py:43-69, group.py:93-115).

Each global round runs every group's rounds from the global model, the
group's whole membership as the cohort, through
:meth:`FedSim.run_cohort_round <fedml_tpu_torch.sim.engine.FedSim.run_cohort_round>`
(one dispatch at a time, as the JAX package's do), then takes the groups'
models' mean weighted by their sample counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fedml_tpu_torch.core import tree as treelib


def random_group_assignment(n_clients: int, n_groups: int, seed: int = 0) -> dict[int, np.ndarray]:
    """group id -> client ids (trainer.py:10-30 random partition), the JAX
    package's seeded numpy draw."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n_clients)
    return {g: np.sort(part) for g, part in enumerate(np.array_split(perm, n_groups))}


@dataclasses.dataclass
class HierConfig:
    group_num: int = 2
    global_comm_round: int = 2
    group_comm_round: int = 2
    group_seed: int = 0


class HierarchicalFedAvg:
    """The two-level loop over a :class:`~fedml_tpu_torch.sim.engine.FedSim`'s
    round program."""

    def __init__(self, sim, hier: HierConfig):
        if sim._per_client:
            raise ValueError(
                "HierarchicalFedAvg drives the broadcast-global round program; "
                "per-client aggregators (decentralized/gossip) are not composable here")
        self.sim = sim
        self.hier = hier
        self.groups = random_group_assignment(
            sim.config.client_num_in_total, hier.group_num, hier.group_seed)

    def run(self, callback=None):
        """``(variables, history)``: one record a global round, its round and
        the pooled eval; each record also goes to ``callback``."""
        sim, hier = self.sim, self.hier
        variables = sim.init_variables()
        server_state = sim.aggregator.init_state(variables)
        history = []
        round_counter = 0
        for g_round in range(hier.global_comm_round):
            group_models, group_weights = [], []
            for client_ids in self.groups.values():
                gvars = {k: v.clone() for k, v in variables.items()}
                for _ in range(hier.group_comm_round):
                    gvars, server_state, _ = sim.run_cohort_round(
                        client_ids, round_counter, gvars, server_state)
                    round_counter += 1
                group_models.append(gvars)
                group_weights.append(
                    float(sum(len(sim.train_data.partition[int(c)]) for c in client_ids)))
            variables = treelib.stacked_weighted_mean(
                treelib.stack(group_models),
                torch.tensor(group_weights, dtype=torch.float32, device=sim.device))
            rec = {"round": g_round}
            rec.update(sim.evaluate(variables))
            history.append(rec)
            if callback:
                callback(rec)
        return variables, history
