"""Parallelism plane, the port of ``fedml_tpu/parallel/``.

- :mod:`fedml_tpu_torch.parallel.mesh` — rank meshes (clients / silo /
  clients x model) over a ``torch.distributed`` world, and what a rank holds
  of a cohort stack.
- :mod:`fedml_tpu_torch.parallel.collectives` — all-gather, all-reduce,
  broadcast and the ring shift over a mesh axis's group, the differentiable
  sum over a bound axis, and tensor parallelism's autograd pairs.
- :mod:`fedml_tpu_torch.parallel.multihost` — forming the world, the global
  client mesh, per-rank staging.
- :mod:`fedml_tpu_torch.parallel.rules` — partition rules: a spec over the
  ``model`` axis for every variable of a client model.
- :mod:`fedml_tpu_torch.parallel.dispatch` — sharded or client-mapped, and
  a tensor's block (``shard``, ``unshard``, ``replicate``).
- :mod:`fedml_tpu_torch.parallel.ring_attention` and
  :mod:`fedml_tpu_torch.parallel.sequence` — the sequence axis: ring
  attention and the sequence-parallel LM train step.
"""

from fedml_tpu_torch.parallel.mesh import (  # noqa: F401
    CLIENT_AXIS,
    MODEL_AXIS,
    SILO_AXIS,
    client_mesh,
    shard_mesh,
    silo_mesh,
)
