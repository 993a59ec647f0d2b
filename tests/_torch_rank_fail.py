"""A rank program for ``tests/test_torch_multirank.py``'s launcher check:
rank 1 raises while rank 0 hangs outside any collective, where the world's
timeout cannot reach it. Imports no JAX (the launcher's ranks import it by
its path)."""

import time

import torch.distributed as dist


def fail_on_rank_one(device):
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    while True:  # hangs until the launcher kills it
        time.sleep(1.0)
