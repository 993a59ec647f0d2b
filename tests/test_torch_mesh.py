"""Rank meshes (``fedml_tpu_torch/parallel/mesh.py``), the collectives'
one-rank identities, ``parallel/multihost.py``'s staging and flat view, and
the engine's mesh checks, in this process: no rank is spawned here
(``tests/test_torch_multirank.py`` and ``test_torch_syncbn.py`` spawn).

A mesh's layout is held to the JAX package's on a world of ranks faked
in this process: ``torch.distributed``'s rank, size and ``new_group`` are
stood in for, a group being the tuple of its ranks, so each rank's groups
can be read. The layouts, the slices, the staged blocks, the flat view and
every error text are bitwise (string-equal) the JAX package's; the JAX
meshes are over this process's 8 CPU devices (``tests/conftest.py``).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import logging
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu.parallel import mesh as jmesh
from fedml_tpu.parallel import multihost as jmulti
from fedml_tpu_torch import convert
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.data.synthetic import gaussian_blobs
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.parallel import collectives
from fedml_tpu_torch.parallel import mesh as tmesh
from fedml_tpu_torch.parallel import multihost as tmulti
from fedml_tpu_torch.sim.engine import FedSim, SimConfig, resolve_dispatch


@pytest.fixture
def world(monkeypatch):
    """A fake world of ``size`` ranks seen from ``rank``: returns a setter."""

    def set_world(size: int, rank: int):
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
        monkeypatch.setattr(dist, "get_world_size",
                            lambda group=None: size if group is None else len(group))
        monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))
        monkeypatch.setattr(dist, "group", types.SimpleNamespace(WORLD=tuple(range(size))))

    return set_world


def _ids(m) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(m.devices)


MESHES = [
    ("client_mesh", (), 8), ("client_mesh", (), 2), ("silo_mesh", (2,), 8),
    ("silo_mesh", (4,), 8), ("silo_mesh", (1,), 2), ("shard_mesh", ((2, 4),), 8),
    ("shard_mesh", ((2, 2),), 8), ("shard_mesh", ((1, 8),), 8),
]


@pytest.mark.parametrize("name,args,n", MESHES, ids=[f"{m}{a}-{n}" for m, a, n in MESHES])
def test_mesh_lays_ranks_as_jax_lays_devices(world, name, args, n):
    jm = getattr(jmesh, name)(*args, jax.devices()[:n])
    ids = _ids(jm)
    for rank in range(n):
        world(n, rank)
        tm = getattr(tmesh, name)(*args, list(range(n)))
        np.testing.assert_array_equal(tm.ranks, ids)
        assert tm.axis_names == tuple(jm.axis_names)
        assert tm.shape == dict(jm.shape) and tm.size == jm.devices.size
        if rank not in ids:  # a proper-divisor shard mesh leaves ranks out
            assert tm.groups == {}
            continue
        where = tuple(np.argwhere(ids == rank)[0])
        for i, axis in enumerate(tm.axis_names):
            assert tm.coord(axis) == where[i]
            line = np.moveaxis(ids, i, -1)[tuple(w for j, w in enumerate(where) if j != i)]
            assert tm.group(axis) == (tuple(line.tolist()) if len(line) > 1 else None)


ERRORS = [("silo_mesh", (3,), 8), ("silo_mesh", (4,), 6), ("shard_mesh", ((3, 2),), 8),
          ("shard_mesh", ((4, 4),), 8), ("shard_mesh", ((0, 2),), 8),
          ("shard_mesh", ("ab",), 8), ("shard_mesh", ((2, 2, 2),), 8)]


@pytest.mark.parametrize("name,args,n", ERRORS, ids=[f"{m}{a}-{n}" for m, a, n in ERRORS])
def test_mesh_errors_are_jax_words(name, args, n):
    with pytest.raises(ValueError) as jerr:
        getattr(jmesh, name)(*args, jax.devices()[:n])
    with pytest.raises(ValueError) as terr:
        getattr(tmesh, name)(*args, list(range(n)))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("text", ["2x4", "2,4", "1X8", "", None, " 3x1", "bad", "2x", "2x4x1"])
def test_parse_mesh_shape_is_jax(text):
    try:
        want = jmesh.parse_mesh_shape(text)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            tmesh.parse_mesh_shape(text)
        assert str(err.value) == str(e)
    else:
        assert tmesh.parse_mesh_shape(text) == want


@pytest.mark.parametrize("name,args,n", [("client_mesh", (), 4), ("silo_mesh", (2,), 4),
                                         ("silo_mesh", (1,), 2), ("silo_mesh", (2,), 8)])
def test_cohort_slices_and_staging_are_jax_shards(world, name, args, n):
    """A rank's ``cohort_batch_slices`` and ``stage_global`` block of a
    ``[C, S, B, ...]`` array are the shard JAX's ``cohort_batch_sharding``
    puts on the device at the rank's place."""
    jm = getattr(jmesh, name)(*args, jax.devices()[:n])
    host = np.arange(4 * 3 * 8 * 2, dtype=np.float32).reshape(4, 3, 8, 2)
    staged = jmulti.stage_global(host, jmesh.cohort_batch_sharding(jm))
    shards = {s.device.id: np.asarray(s.data) for s in staged.addressable_shards}
    index = jmesh.cohort_batch_sharding(jm).devices_indices_map(host.shape)
    for rank in range(n):
        world(n, rank)
        tm = getattr(tmesh, name)(*args, list(range(n)))
        rows, cols = tmesh.cohort_batch_slices(tm, 4, 8)
        jrows, _, jcols = index[jax.devices()[rank]][:3]
        assert (rows.start, rows.stop) == (jrows.start or 0, jrows.stop or 4)
        assert (cols.start, cols.stop) == (jcols.start or 0, jcols.stop or 8)
        np.testing.assert_array_equal(tmulti.stage_global(host, tm).numpy(), shards[rank])


def test_cohort_slices_refuse_uneven_splits(world):
    world(2, 0)
    with pytest.raises(ValueError, match="3 cohort slots do not shard"):
        tmesh.cohort_batch_slices(tmesh.client_mesh([0, 1]), 3, 8)
    with pytest.raises(ValueError, match="batch size 7 does not split"):
        tmesh.cohort_batch_slices(tmesh.silo_mesh(1, [0, 1]), 2, 7)


def test_a_multi_rank_mesh_needs_a_world():
    assert tmesh.client_mesh().shape == {"clients": 1}  # no world: rank 0 alone
    with pytest.raises(ValueError, match="needs an initialised torch.distributed world"):
        tmesh.client_mesh([0, 1])


def test_global_client_mesh_is_jax(world):
    for silo in (1, 2, 4):
        jm = jmulti.global_client_mesh(silo)
        world(len(jax.devices()), 0)
        tm = tmulti.global_client_mesh(silo)
        np.testing.assert_array_equal(tm.ranks, _ids(jm))
        assert tm.axis_names == tuple(jm.axis_names)
    with pytest.raises(ValueError, match="8 devices not divisible by silo=3"):
        tmulti.global_client_mesh(3)


def test_flatten_variables_is_the_jax_flat_view(rng):
    jm = JaxResNet(depth=8, num_classes=10)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(0), np.zeros((2, 8, 8, 3), np.float32)))
    np.testing.assert_array_equal(tmulti.flatten_variables(convert.from_flax(variables)),
                                  jmulti.flatten_variables(variables))


def test_collectives_over_one_rank_are_the_identity():
    collectives.TRAFFIC.reset()
    t = torch.arange(6.0).reshape(3, 2)
    assert collectives.all_reduce(t, None) is t
    assert collectives.all_gather(t, None) is t
    assert collectives.broadcast(t, 0, None) is t
    with collectives.bind("silo", None):
        assert collectives.bound("silo") is None
        assert collectives.axis_sum(t, "silo") is t
    assert collectives.TRAFFIC.snapshot() == {}


def test_nccl_that_fails_to_initialise_raises_and_forms_no_world():
    """This host has no NCCL: asking for it raises, and no gloo world is
    formed in its place."""
    with pytest.raises((RuntimeError, ValueError)):
        tmulti.init_multihost(f"localhost:{_port()}", 1, 0, backend="nccl", platform="cuda",
                              timeout_s=10)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs platform='cuda'"):
        tmulti.init_multihost("localhost:1", 1, 0, backend="nccl", platform="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tmulti.init_multihost("localhost:1", 1, 0, backend="mpi", platform="cpu")
    assert tmulti.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tmulti.rank_device("cuda")


def _port():
    from fedml_tpu_torch.parallel.launch import free_port

    return free_port()


def _sim(mesh, **config):
    train, test = gaussian_blobs(n_clients=6, samples_per_client=16, num_classes=4, seed=1)
    model = create_model("lr", 4, device="cpu", input_shape=(16,))
    cfg = SimConfig(**{**dict(client_num_in_total=6, client_num_per_round=3, batch_size=8,
                              comm_round=1), **config})
    return FedSim(ClientTrainer(module=model, optimizer=sgd(0.1)), train, test, cfg,
                  device="cpu", mesh=mesh)


def _two_ranks():
    # the layout of a client mesh of two ranks, seen without a world: enough
    # for the checks FedSim makes before any collective
    return tmesh.RankMesh(np.arange(2), ("clients",), {})


def test_fedsim_refuses_the_model_axis_and_two_mesh_sources(caplog):
    """A model axis without shard rules is pure replication, named in the
    JAX engine's words; a 1 x 2 ``mesh_shape`` needs two ranks
    (``shard_mesh``'s count error without a world); a mesh given twice is
    refused."""
    with caplog.at_level(logging.WARNING):
        _sim(tmesh.RankMesh(np.arange(2).reshape(1, 2), ("clients", "model"), {}))
    assert "mesh has a 2-way 'model' axis but no shard_rules" in caplog.text
    with pytest.raises(ValueError, match=r"requires 2 devices .* only 1 are available"):
        _sim(None, mesh_shape=(1, 2))
    cfg = SimConfig(client_num_in_total=6, client_num_per_round=3, mesh_shape=(1, 1))
    train, test = gaussian_blobs(n_clients=6, samples_per_client=16, num_classes=4, seed=1)
    with pytest.raises(ValueError, match="mesh_shape and an explicit mesh= were both given"):
        FedSim(ClientTrainer(module=create_model("lr", 4, device="cpu", input_shape=(16,))),
               train, test, cfg, device="cpu", mesh=tmesh.client_mesh())


def test_packed_lanes_and_blocks_over_ranks_are_refused():
    """Packed lanes run per client shard (the lanes' geometry of a client
    mesh of two, seen without a world); blocks over ranks stay off."""
    packed = _sim(_two_ranks(), pack_lanes=2)
    assert packed.pack_summary()["lane_capacity_per_pass"] == 2 * 2 * packed._s_lane
    assert (packed._c_pad, packed._c_local, packed._row0) == (4, 2, 0)
    sim = _sim(_two_ranks(), block_dispatch=True)
    assert not sim._block_dispatch  # blocks turn off over ranks, as JAX's sharded plans
    with pytest.raises(ValueError, match="each round dispatches alone"):
        sim.stage_block(0, 2)
    cfg = SimConfig(block_dispatch=True)
    assert resolve_dispatch(cfg, 1 << 20, "cuda") == (True, True)
    assert resolve_dispatch(cfg, 1 << 20, "cuda", ranks=2) == (True, False)


def test_padding_is_named_and_sizes_the_codec(caplog):
    """The order-statistic warning, in the JAX engine's words, and the
    quantized uplink's error-feedback slots: the padded cohort."""
    with caplog.at_level(logging.WARNING):
        _sim(_two_ranks(), robust_rule="median")
    assert ("robust rule 'median' runs over a padded cohort stack: 3 real clients + 1 "
            "zero-delta padding slots (cohort not divisible by the 2-way client mesh)"
            in caplog.text)
    sim = _sim(_two_ranks(), client_num_per_round=6, compressor="q8", comm_round=1)
    state = sim.aggregator.init_state(sim.init_variables())
    assert {v.shape[0] for v in jax.tree.leaves(state, is_leaf=torch.is_tensor)
            if torch.is_tensor(v) and v.dim() >= 2} == {6}
    sim3 = _sim(_two_ranks(), client_num_in_total=3, client_num_per_round=3,
                compressor="q8")
    state3 = sim3.aggregator.init_state(sim3.init_variables())
    assert {v.shape[0] for v in jax.tree.leaves(state3, is_leaf=torch.is_tensor)
            if torch.is_tensor(v) and v.dim() >= 2} == {4}
