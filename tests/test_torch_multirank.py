"""Cohort parallelism over ranks: ``FedSim`` on a client mesh of two gloo
ranks (``parallel/mesh.py``, ``collectives.py``, ``launch.py``,
``rehearsal.py``), the multihost entry point, and the launcher's failure
path, against the port on one rank and the JAX engine on a 2-device client
mesh.

One launch of two ranks runs every FedSim job and a probe of the
collectives in a module fixture; one runs
``main_multihost`` with ``--local_device_count 2``; one checks that a rank
that raises fails its launcher. Tolerances, fixed before the first run:

- two ranks against the port's one rank: bitwise (each rank's vmapped or
  client-by-client training is one rank's on its slots, and the gathered
  stack is folded in the same order), for LR, the padded median cohort's
  unpadded twin, the gossip (per-client) mode, the quantized uplink and the
  small f32 LM through the flash path's plain version;
- against the JAX engine on ``client_mesh(jax.devices()[:2])`` from the
  same initial variables: rtol 1e-5, atol 1e-6 (the JAX package's own
  multihost yardstick, ``tests/test_multihost.py``), the JAX multihost
  config (gaussian blobs, 8 clients, 4 a round, B=8, E=2, SGD 0.2, 3
  rounds), and a cohort of 3 under ``robust_rule="median"``: both engines
  pad it to 4 with a zero-weight slot that holds the global model, which
  the median reads;
- ``main_multihost`` on two spawned ranks: both npz files bitwise equal,
  and equal to one rank's.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.data.synthetic import gaussian_blobs
from fedml_tpu.models.linear import LogisticRegression
from fedml_tpu.parallel.mesh import client_mesh as jax_client_mesh
from fedml_tpu.parallel.multihost import flatten_variables as jax_flat
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.exp import main_multihost
from fedml_tpu_torch.parallel import launch, rehearsal

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
BLOBS = dict(client_num_in_total=8, client_num_per_round=4, batch_size=8, comm_round=3,
             epochs=2, frequency_of_the_test=3, seed=0)


def _blobs():
    train, test = gaussian_blobs(n_clients=8, samples_per_client=24, num_classes=4, seed=11)
    return train, test


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's runs on a 2-device client mesh: the multihost config
    and its median twin with a cohort of 3, from the same init."""
    train, test = _blobs()
    trainer = JaxTrainer(module=LogisticRegression(num_classes=4), optimizer=optax.sgd(0.2),
                         epochs=2)
    runs, init = {}, None
    for name, extra in (("mean", {}), ("median", {"client_num_per_round": 3,
                                                  "robust_rule": "median"})):
        sim = JaxSim(trainer, train, test, JaxConfig(**{**BLOBS, **extra}),
                     mesh=jax_client_mesh(jax.devices()[:2]))
        init = init if init is not None else jax.tree.map(np.asarray, sim.init_variables())
        variables, history = sim.run(variables=init)
        runs[name] = (jax_flat(variables), history)
    return init, runs


def _lr_spec(init, **config):
    train, test = _blobs()
    return dict(data=(train.arrays, train.partition, test),
                model=("lr", 4, {"input_shape": (16,)}),
                trainer=dict(optimizer=("sgd", 0.2), epochs=2),
                config={**BLOBS, **config},
                init={k: v.numpy() for k, v in convert.from_flax(init).items()})


def _lm_spec():
    """The vmapped small f32 LM of ``chip_smoke.py``'s ``[e2e vmap]``, cut
    for the CPU, with ``attn_impl="flash"`` (the plain version here)."""
    rng = np.random.RandomState(0)
    v, t, n_clients, per = 32, 16, 4, 6
    x = rng.randint(0, v, (n_clients * per + 4, t)).astype(np.int32)
    mask = np.ones_like(x, dtype=np.float32)
    mask[::3, 12:] = 0.0
    n = n_clients * per
    part = {c: np.arange(c * per, (c + 1) * per - c) for c in range(n_clients)}
    y = np.roll(x, -1, axis=1)
    return dict(data=({"x": x[:n], "y": y[:n], "mask": mask[:n]}, part,
                      {"x": x[n:], "y": y[n:], "mask": mask[n:]}),
                model=("transformer", v, {"embed_dim": 16, "num_layers": 2, "num_heads": 2,
                                          "max_len": t, "attn_impl": "flash"}),
                trainer=dict(task="nwp", optimizer=("sgd", 0.1, 0.9), epochs=1),
                config=dict(client_num_in_total=n_clients, client_num_per_round=2,
                            batch_size=4, comm_round=2, epochs=1, frequency_of_the_test=1,
                            eval_batch_size=4, seed=0))


JOBS = ["lr vmap", "lr scan", "median of 3", "median of 4", "gossip ring", "q8 uplink", "lm",
        "probe"]


@pytest.fixture(scope="module")
def jobs(jax_runs):
    init, _ = jax_runs
    return [
        ("run_sim", _lr_spec(init)),
        ("run_sim", _lr_spec(init, cohort_execution="scan")),
        ("run_sim", _lr_spec(init, client_num_per_round=3, robust_rule="median")),
        ("run_sim", _lr_spec(init, robust_rule="median")),
        ("run_sim", dict(_lr_spec(init, client_num_per_round=8), gossip_ring=True)),
        ("run_sim", _lr_spec(init, compressor="q8", error_feedback=False)),
        ("run_sim", _lm_spec()),
        ("world_probe", {}),
    ]


@pytest.fixture(scope="module")
def two_ranks(jobs):
    """Every job on a client mesh of two gloo ranks, one launch."""
    return launch.launch(rehearsal.run_jobs, 2, jobs, backend="gloo", platform="cpu",
                         timeout_s=240.0)


@pytest.fixture(scope="module")
def one_rank(jobs):
    """The FedSim jobs in this process, without a world (the probe, last,
    needs one)."""
    return rehearsal.run_jobs(CPU, jobs[:-1])


SIMS = [name for name in JOBS if name not in ("median of 3", "probe")]


@pytest.mark.parametrize("job", [JOBS.index(name) for name in SIMS], ids=SIMS)
def test_client_mesh_of_two_ranks_is_one_rank_bitwise(two_ranks, one_rank, job):
    a, b = (r[job] for r in two_ranks)
    assert a["mesh"] == {"clients": 2} and one_rank[job]["mesh"] == {"clients": 1}
    np.testing.assert_array_equal(a["flat"], b["flat"])
    np.testing.assert_array_equal(a["flat"], one_rank[job]["flat"])
    assert a["history"] == b["history"] == one_rank[job]["history"]
    # one all-gather of the cohort's models, weights, step counts and losses a round
    rounds = len(a["history"])
    assert a["traffic"]["all_gather"]["calls"] == rounds
    assert a["traffic"]["all_gather"]["host_staged"] == 0
    assert "all_gather" not in one_rank[job]["traffic"]


def test_client_mesh_matches_the_jax_client_mesh(two_ranks, jax_runs):
    flat, history = jax_runs[1]["mean"]
    port = two_ranks[0][0]
    np.testing.assert_allclose(port["flat"], flat, rtol=1e-5, atol=1e-6)
    for rp, rj in zip(port["history"], history):
        for k in rp:
            np.testing.assert_allclose(rp[k], rj[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_padded_median_cohort_matches_jax(two_ranks, jax_runs):
    """A cohort of 3 on two ranks pads to 4 slots, as the JAX engine pads it
    on two devices; the median reads the padding slot (the global model)."""
    flat, history = jax_runs[1]["median"]
    a, b = (r[2] for r in two_ranks)
    np.testing.assert_array_equal(a["flat"], b["flat"])
    np.testing.assert_allclose(a["flat"], flat, rtol=1e-5, atol=1e-6)
    for rp, rj in zip(a["history"], history):
        for k in rp:
            np.testing.assert_allclose(rp[k], rj[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_small_lm_launches_the_flash_path_on_every_rank(two_ranks, one_rank):
    """On the CPU the flash path's plain version runs and counts no launch:
    a rank's count is the one rank's, 0 here (the card counts them)."""
    assert [r[6]["flash"] for r in two_ranks] == [one_rank[6]["flash"]] * 2 == [(0, 0)] * 2


def test_collectives_over_the_world_of_two(two_ranks):
    """The world's own all-reduce, and ``collectives``' all-gather (in rank
    order) and broadcast (from the last rank), over gloo."""
    for r in two_ranks:
        assert r[7] == {"backend": "gloo", "world": 2, "sum": 3.0, "gather": [1.0, 2.0],
                        "broadcast": 2.0}


def test_main_multihost_two_spawned_ranks_write_identical_npz(tmp_path):
    argv = ["--platform", "cpu", "--comm_round", "3", "--frequency_of_the_test", "3",
            "--timeout_s", "120"]
    out = tmp_path / "cli.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.exp.main_multihost", "--local_device_count",
         "2", "--out", str(out)] + argv,
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    a, b = (np.load(tmp_path / f"cli.rank{r}.npz") for r in range(2))
    main_multihost.main(argv + ["--out", str(tmp_path / "one.npz")])
    one = np.load(tmp_path / "one.npz")
    assert sorted(a.files) == sorted(one.files)
    assert {"flat", "Test_Acc", "Test_Loss", "Train_Loss"} <= set(a.files)
    for k in a.files:
        if k != "round_time":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k], one[k], err_msg=k)


def test_a_rank_that_raises_fails_its_launcher():
    """Rank 1 raises while rank 0 hangs outside any collective: the launch
    fails naming rank 1's error and rank 0 as giving no result, and rank 0
    is killed, well before the launch's time limit."""
    from tests._torch_rank_fail import fail_on_rank_one

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose") as err:
        launch.launch(fail_on_rank_one, 2, backend="gloo", platform="cpu", timeout_s=120.0)
    assert "ranks [1] raised, ranks [0] gave no result" in str(err.value)
    assert time.monotonic() - t0 < 60.0
