"""Parallelism plane, the port of ``fedml_tpu/parallel/``: the data-parallel
half (ROADMAP §A12a).

- :mod:`fedml_tpu_torch.parallel.mesh` — rank meshes (clients / silo /
  clients x model) over a ``torch.distributed`` world, and what a rank holds
  of a cohort stack.
- :mod:`fedml_tpu_torch.parallel.collectives` — all-gather, all-reduce and
  broadcast over a mesh axis's group, and the differentiable sum over a
  bound axis.
- :mod:`fedml_tpu_torch.parallel.multihost` — forming the world, the global
  client mesh, per-rank staging.

The partition rules, the compile dispatcher and the sequence axis
(``rules``, ``dispatch``, ``sequence``, ``ring_attention``) are ROADMAP
§A12b.
"""

from fedml_tpu_torch.parallel.mesh import (  # noqa: F401
    CLIENT_AXIS,
    MODEL_AXIS,
    SILO_AXIS,
    client_mesh,
    shard_mesh,
    silo_mesh,
)
