"""Synthetic federated datasets, a copy of ``fedml_tpu/data/synthetic.py``
(bitwise-equal arrays for the same arguments).

Two roles:
1. The LEAF ``synthetic_(alpha,beta)`` benchmark family (reference:
   fedml_api/data_preprocessing/MNIST/data_loader.py consumes these as
   pre-generated LEAF JSON; the generator is the LEAF synthetic task —
   per-client logistic models drawn from client-specific Gaussians).
2. In-memory test fixtures — the reference has no synthetic fixtures and
   downloads real datasets in CI (CI-install.sh:44-83); we fix that gap so the
   test suite runs hermetically.
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.core import partition as partlib
from fedml_tpu_torch.sim.cohort import FederatedArrays


def synthetic_classification(
    n_clients: int = 10,
    samples_per_client: tuple[int, int] = (20, 60),
    num_classes: int = 10,
    dim: int = 60,
    alpha: float = 0.0,
    beta: float = 0.0,
    seed: int = 0,
    size_dist: str = "uniform",
) -> tuple[FederatedArrays, dict[str, np.ndarray]]:
    """LEAF-style synthetic(α, β) generator.

    α controls how much local models differ across clients; β controls how
    much local data distributions differ. Each client k draws
    W_k ~ N(u_k, 1), u_k ~ N(0, α); x ~ N(v_k, Σ), v_k ~ N(B_k, 1),
    B_k ~ N(0, β); y = argmax(softmax(W_k x + b_k)). Returns
    (train FederatedArrays, pooled test arrays).

    ``size_dist="lognormal"`` draws per-client sample counts as
    ``lognormal(4, 2) + 50`` — the reference generator's heavy-tailed
    recipe (data/synthetic_1_1/generate_synthetic.py), used by the
    BASELINE reproduction; "uniform" draws from ``samples_per_client``
    (compact shapes for tests). Lognormal draws are capped at 10,000
    samples/client (the unbounded tail would occasionally demand
    million-sample clients); ~0.5% of draws clip. The caller can check
    ``client_sizes()`` to see whether a given seed hit the cap.
    """
    rng = np.random.RandomState(seed)
    sigma = np.diag(np.asarray([(j + 1) ** -1.2 for j in range(dim)]))

    xs, ys, owners = [], [], []
    if size_dist == "lognormal":
        sizes = (rng.lognormal(4.0, 2.0, n_clients).astype(int) + 50)
        sizes = np.minimum(sizes, 10_000)  # bound the heavy tail
    else:
        sizes = rng.randint(samples_per_client[0], samples_per_client[1] + 1, n_clients)
    for k in range(n_clients):
        u_k = rng.normal(0.0, alpha)
        b_center = rng.normal(0.0, beta)
        v_k = rng.normal(b_center, 1.0, dim)
        W = rng.normal(u_k, 1.0, (dim, num_classes))
        b = rng.normal(u_k, 1.0, num_classes)
        x = rng.multivariate_normal(v_k, sigma, sizes[k]).astype(np.float32)
        logits = x @ W + b
        y = np.argmax(logits, axis=1).astype(np.int32)
        xs.append(x)
        ys.append(y)
        owners.append(np.full(sizes[k], k))

    x = np.concatenate(xs)
    y = np.concatenate(ys)
    owner = np.concatenate(owners)

    # 90/10 train/test split within each client; test pooled globally
    train_idx, test_idx = [], []
    for k in range(n_clients):
        idx = np.where(owner == k)[0]
        rng.shuffle(idx)
        cut = max(1, int(0.9 * len(idx)))
        train_idx.append(idx[:cut])
        test_idx.append(idx[cut:])

    tr = np.concatenate(train_idx)
    te = np.concatenate(test_idx)
    remap = -np.ones(len(x), dtype=np.int64)
    remap[tr] = np.arange(len(tr))
    part = {
        k: np.sort(remap[train_idx[k]]) for k in range(n_clients)
    }
    train = FederatedArrays({"x": x[tr], "y": y[tr]}, part)
    test = {"x": x[te], "y": y[te]}
    return train, test


def gaussian_blobs(
    n_clients: int = 8,
    samples_per_client: int = 64,
    num_classes: int = 4,
    dim: int = 16,
    partition_method: str = "homo",
    partition_alpha: float = 0.5,
    noise: float = 0.6,
    seed: int = 0,
) -> tuple[FederatedArrays, dict[str, np.ndarray]]:
    """Separable-blob fixture: fast to learn, good for smoke/equivalence tests."""
    rng = np.random.RandomState(seed)
    n = n_clients * samples_per_client
    centers = rng.normal(0.0, 2.0, (num_classes, dim))
    y = rng.randint(0, num_classes, n).astype(np.int32)
    x = (centers[y] + rng.normal(0.0, noise, (n, dim))).astype(np.float32)
    part = partlib.partition(partition_method, y, n_clients, partition_alpha, seed)
    n_test = max(num_classes * 8, n // 5)
    yt = rng.randint(0, num_classes, n_test).astype(np.int32)
    xt = (centers[yt] + rng.normal(0.0, noise, (n_test, dim))).astype(np.float32)
    return FederatedArrays({"x": x, "y": y}, part), {"x": xt, "y": yt}
