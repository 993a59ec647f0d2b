"""In-silo data parallelism: ``ops/syncbn.py``, the port's BatchNorm in a
silo, ``make_silo_local_train`` and ``FedSim`` on a ``1 x 2`` clients x silo
rank mesh, against the JAX package and against the port on one rank.

The two-rank runs go through one launch of two gloo ranks on the CPU
(``parallel/launch.py``, spawned processes, one torch thread each) in a
module fixture; the one-rank runs are the same ``parallel/rehearsal.py``
functions called in this process without a world. Tolerances, fixed
before the first run:

- ``SyncBatchNorm`` on two ranks against flax's ``SyncBatchNorm`` under
  ``shard_map`` over two CPU devices (outputs, new statistics, gradients of
  the scale, the bias and the input): 1e-6 absolute plus 1e-6 relative
  (the scale's gradient, a sum of 128 products, is ~12: f32 sums of that
  size taken in other orders part by a few ulps of it); against the port's
  one rank on the whole batch: the same;
- FedSim with a depth-8 BatchNorm ResNet on the ``1 x 2`` mesh: within
  1e-12 of the port's one rank in float64 (only the order of the silo's
  sums differs, and the f32 fold rounds it away), within 1e-6 in f32, and
  within 1e-5 of the JAX engine on ``silo_mesh(1, devices[:2])`` in f32
  (two packages' f32 convolutions and BatchNorms over two rounds);
- ``make_silo_local_train`` on two ranks against ``make_local_train`` on
  the whole batch: rtol 1e-5, atol 1e-6, as ``tests/test_cross_silo.py``
  holds the JAX one.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu.ops.syncbn import SyncBatchNorm as JaxSyncBN
from fedml_tpu.parallel import compat
from fedml_tpu.parallel.mesh import silo_mesh as jax_silo_mesh
from fedml_tpu.sim.cohort import FederatedArrays as JaxArrays
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.ops.syncbn import SyncBatchNorm, batch_moments
from fedml_tpu_torch.parallel import launch, rehearsal
from fedml_tpu_torch.parallel.collectives import bind

CPU = torch.device("cpu")
N_CLIENTS, PER, B = 4, 20, 8


def _bn_data():
    rng = np.random.RandomState(3)
    x = (rng.randn(8, 3, 4, 4) * 2.0 + 0.5).astype(np.float32)  # NCHW
    dy = rng.randn(8, 3, 4, 4).astype(np.float32)
    return dict(x=x, dy=dy, scale=(1.0 + 0.1 * rng.randn(3)).astype(np.float32),
                bias=(0.1 * rng.randn(3)).astype(np.float32), momentum=0.9)


def _images():
    rng = np.random.RandomState(0)
    n = N_CLIENTS * PER
    x = rng.randn(n + 16, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 10, n + 16).astype(np.int32)
    part = {c: np.arange(c * PER, (c + 1) * PER - 3 * c) for c in range(N_CLIENTS)}
    return {"x": x[:n], "y": y[:n]}, part, {"x": x[n:], "y": y[n:]}


CONFIG = dict(client_num_in_total=N_CLIENTS, client_num_per_round=2, batch_size=B,
              comm_round=2, epochs=1, frequency_of_the_test=2, seed=0)
LR, MOMENTUM, WD = 0.05, 0.9, 1e-3


@pytest.fixture(scope="module")
def jax_resnet_run():
    """The JAX engine's two rounds on ``silo_mesh(1, devices[:2])`` and its
    initial variables (flax layout)."""
    train, part, test = _images()
    trainer = JaxTrainer(module=JaxResNet(depth=8, num_classes=10),
                         optimizer=optax.chain(optax.add_decayed_weights(WD),
                                               optax.sgd(LR, momentum=MOMENTUM)), epochs=1)
    sim = JaxSim(trainer, JaxArrays(train, part), test, JaxConfig(**CONFIG),
                 mesh=jax_silo_mesh(1, jax.devices()[:2]))
    init = jax.tree.map(np.asarray, sim.init_variables())
    variables, history = sim.run(variables=init)
    return init, jax.tree.map(np.asarray, variables), history


def _sim_spec(init, dtype, mode="vmap"):
    train, part, test = _images()
    return dict(data=(train, part, test),
                model=("cifar_resnet", 10, {"depth": 8, "dtype": dtype}),
                trainer=dict(optimizer=("sgd", LR, MOMENTUM, WD), epochs=1),
                config=dict(CONFIG, cohort_execution=mode), silo=2,
                init={k: v.numpy().astype(np.float64 if dtype == "float64" else np.float32)
                      for k, v in convert.from_flax(init).items()})


def _silo_train_spec(init):
    train, part, _ = _images()
    rng = np.random.RandomState(5)
    idx = rng.permutation(part[0])[:16].reshape(2, B)  # [S, B]
    batches = {"x": train["x"][idx], "y": train["y"][idx],
               "mask": np.ones((2, B), np.float32)}
    batches["mask"][1, 5:] = 0.0  # a part-padded last step: one rank's half is 3 rows
    return dict(batches=batches, model=("cifar_resnet", 10, {"depth": 8}),
                trainer=dict(optimizer=("sgd", LR, MOMENTUM, WD), epochs=2),
                init={k: v.numpy() for k, v in convert.from_flax(init).items()})


@pytest.fixture(scope="module")
def jobs(jax_resnet_run):
    init = jax_resnet_run[0]
    return [("sync_batchnorm", _bn_data()),
            ("run_sim", _sim_spec(init, "float64")),
            ("run_sim", _sim_spec(init, "float32")),
            ("run_sim", _sim_spec(init, "float32", "scan")),
            ("silo_local_train", _silo_train_spec(init))]


@pytest.fixture(scope="module")
def two_ranks(jobs):
    """Every job on a ``1 x 2`` mesh of two gloo ranks, one launch."""
    ranks = launch.launch(rehearsal.run_jobs, 2, jobs, backend="gloo", platform="cpu",
                          timeout_s=240.0)
    return ranks


@pytest.fixture(scope="module")
def one_rank(jobs):
    return rehearsal.run_jobs(CPU, jobs)


def _flax_sync_bn(d):
    """flax's SyncBatchNorm on ``x`` sharded over a 2-device ``silo`` mesh
    (NHWC), the loss ``sum(y * dy)`` taken outside the map: (y, new stats,
    d scale, d bias, d x), NCHW where the port's are."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("silo",))
    bn = JaxSyncBN(momentum=d["momentum"])
    stats = {"bn": {"mean": jnp.zeros(3), "var": jnp.ones(3)}}
    x = jnp.asarray(d["x"].transpose(0, 2, 3, 1))
    dy = jnp.asarray(d["dy"].transpose(0, 2, 3, 1))

    def apply(params, x):
        return bn.apply({"params": params, "batch_stats": stats}, x,
                        use_running_average=False, mutable=["batch_stats"])

    mapped = compat.shard_map(apply, mesh=mesh, in_specs=(P(), P("silo")),
                              out_specs=(P("silo"), P()), check_vma=False)

    def loss(params, x):
        y, _ = mapped(params, x)
        return jnp.sum(y * dy)

    params = {"bn": {"scale": jnp.asarray(d["scale"]), "bias": jnp.asarray(d["bias"])}}
    y, new = jax.jit(mapped)(params, x)
    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return {"y": nchw(y), "mean": np.asarray(new["batch_stats"]["bn"]["mean"]),
            "var": np.asarray(new["batch_stats"]["bn"]["var"]),
            "dscale": np.asarray(g_params["bn"]["scale"]),
            "dbias": np.asarray(g_params["bn"]["bias"]), "dx": nchw(g_x)}


def test_sync_batchnorm_two_ranks_match_flax_under_shard_map(two_ranks):
    ref = _flax_sync_bn(_bn_data())
    halves = [r[0] for r in two_ranks]
    np.testing.assert_allclose(np.concatenate([h["y"] for h in halves]), ref["y"], atol=1e-6)
    np.testing.assert_allclose(np.concatenate([h["dx"] for h in halves]), ref["dx"], atol=1e-6)
    for h in halves:
        for k in ("mean", "var", "dscale", "dbias"):
            np.testing.assert_allclose(h[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_sync_batchnorm_two_ranks_match_one_rank_on_the_whole_batch(two_ranks, one_rank):
    whole, halves = one_rank[0], [r[0] for r in two_ranks]
    for k in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([h[k] for h in halves]), whole[k], atol=1e-6)
    for h in halves:
        for k in ("mean", "var", "dscale", "dbias"):
            np.testing.assert_allclose(h[k], whole[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_unbound_sync_batchnorm_is_plain_batchnorm_bitwise():
    """Without a bound silo (or under a group of one) the moments are the
    port's BatchNorm's, the same ops in the same order."""
    from fedml_tpu_torch.models.resnet import BatchNorm

    d = _bn_data()
    x = torch.tensor(d["x"])
    plain = BatchNorm(3, device="cpu")
    sync = SyncBatchNorm(3, device="cpu")
    with bind("silo", None):
        y_sync, stats_sync = sync(x, train=True)
    y_plain, stats_plain = plain(x, train=True)
    assert torch.equal(y_sync, y_plain)
    for a, b in zip(stats_sync, stats_plain):
        assert torch.equal(a, b)
    mean, var = batch_moments(x, (0, 2, 3))
    assert torch.equal(mean, x.mean((0, 2, 3)))
    assert torch.equal(var, torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0))


def test_sync_batchnorm_on_dense_features_matches_flax():
    """``[N, F]`` input normalises over N, as flax's over all but the last
    axis; eval mode uses the running statistics."""
    rng = np.random.RandomState(1)
    x = rng.randn(6, 5).astype(np.float32)
    variables = JaxSyncBN().init(jax.random.key(0), jnp.asarray(x), use_running_average=False)
    y_ref, new = JaxSyncBN().apply(variables, jnp.asarray(x), use_running_average=False,
                                   mutable=["batch_stats"])
    bn = SyncBatchNorm(5, device="cpu")
    y, (mean, var) = bn(torch.tensor(x), train=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=1e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(new["batch_stats"]["bn"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(new["batch_stats"]["bn"]["var"]),
                               atol=1e-6)
    y_eval, none = bn(torch.tensor(x), train=False)
    assert none is None
    np.testing.assert_allclose(y_eval.detach().numpy(), x / np.sqrt(1.0 + 1e-5), atol=1e-6)


@pytest.mark.parametrize("job", [1, 2, 3], ids=["float64", "float32", "float32-scan"])
def test_silo_mesh_fedsim_matches_one_rank(two_ranks, one_rank, job):
    a, b = (r[job] for r in two_ranks)
    assert a["mesh"] == {"clients": 1, "silo": 2}
    assert one_rank[job]["mesh"] == {"clients": 1}
    np.testing.assert_array_equal(a["flat"], b["flat"])  # the silo's ranks agree bitwise
    atol = 1e-12 if job == 1 else 1e-6
    np.testing.assert_allclose(a["flat"], one_rank[job]["flat"], rtol=0, atol=atol)
    for ra, r1 in zip(a["history"], one_rank[job]["history"]):
        assert set(ra) == set(r1)
        for k in ra:
            np.testing.assert_allclose(ra[k], r1[k], rtol=0, atol=max(atol, 1e-6), err_msg=k)
    # each step reduced its gradients and every BatchNorm's moments once
    assert a["traffic"]["all_reduce"]["calls"] > 0
    assert a["traffic"]["all_reduce"]["host_staged"] == 0  # CPU tensors over gloo


def test_silo_mesh_fedsim_matches_the_jax_silo_mesh(two_ranks, jax_resnet_run):
    _, variables, history = jax_resnet_run
    from fedml_tpu.parallel.multihost import flatten_variables as jax_flat

    port = two_ranks[0][2]
    np.testing.assert_allclose(port["flat"], jax_flat(variables), rtol=0, atol=1e-5)
    for rp, rj in zip(port["history"], history):
        for k in rp:
            if k != "round":
                np.testing.assert_allclose(rp[k], rj[k], rtol=0, atol=1e-5, err_msg=k)


def test_silo_local_train_on_two_ranks_matches_local_train(two_ranks, one_rank):
    whole = one_rank[4]
    for r in two_ranks:
        for k, v in r[4]["variables"].items():
            np.testing.assert_allclose(v, whole["variables"][k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(r[4]["train_loss"], whole["train_loss"], rtol=1e-5)
