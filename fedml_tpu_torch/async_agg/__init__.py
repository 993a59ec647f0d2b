"""The barrier-free server plane, the port of ``fedml_tpu/async_agg/``:
buffered-async aggregation and hierarchical aggregation trees.

Two cooperating planes over the message-passing FedAvg protocol:

- :mod:`fedml_tpu_torch.async_agg.server`: a FedBuff-style asynchronous
  server (Nguyen et al., 2022): every upload folds into the streaming
  accumulator on arrival with a staleness weight
  (:mod:`fedml_tpu_torch.async_agg.staleness`, the FedAsync decay family),
  and a new global model version is emitted every ``buffer_goal``
  arrivals, with no round barrier anywhere.
- :mod:`fedml_tpu_torch.async_agg.tree`: an edge-aggregator tree (clients
  -> edge tiers -> root): each tier is itself a streaming accumulator over
  the comm backends and forwards ONE folded super-update upstream, so root
  fan-in is O(tiers), not O(clients).

Bit-identity contract (``tests/test_torch_async_agg.py``, and on the card
``chip_smoke.py``'s ``[async]`` phase): async with ``buffer_goal ==
worker_num`` and the constant staleness weight reproduces the sync
streaming path bit for bit, and a 1-tier tree reproduces the flat server
bit for bit. The folds are host numpy, the JAX package's arithmetic; the
clients train on the card.
"""

from fedml_tpu_torch.async_agg.staleness import STALENESS_FAMILIES, make_staleness_fn
from fedml_tpu_torch.async_agg.server import (
    AsyncCompressedFedAvgServerManager,
    AsyncFedAggregator,
    AsyncFedAvgServerManager,
    AsyncRobustFedAvgServerManager,
)
from fedml_tpu_torch.async_agg.tree import (
    EdgeAggregatorManager,
    TierAggregator,
    TreeFedAvgServerManager,
    TreeTopology,
    run_tree_fedavg,
    run_tree_fedavg_loopback,
)

__all__ = [
    "STALENESS_FAMILIES",
    "make_staleness_fn",
    "AsyncFedAggregator",
    "AsyncFedAvgServerManager",
    "AsyncCompressedFedAvgServerManager",
    "AsyncRobustFedAvgServerManager",
    "TierAggregator",
    "EdgeAggregatorManager",
    "TreeFedAvgServerManager",
    "TreeTopology",
    "run_tree_fedavg",
    "run_tree_fedavg_loopback",
]
