"""The families on the port's wire path against the JAX package's, on the
CPU: cross-silo (``algorithms/cross_silo.py``), TurboAggregate's secure
aggregation (``algorithms/turboaggregate_dist.py``, its dropout and
recovery cases), and the CLIs (``main_fedavg --backend loopback``,
``main_turboaggregate``), with every flag the slice does not port raising
its ROADMAP item.

Each protocol run is in a daemon thread under a deadline of its own (60 s,
``tests/test_torch_fedavg_dist.py``'s ``_within_deadline``). The port
starts from the JAX run's initial variables.

Tolerances: cross-silo atol 1e-5 of the JAX run; TurboAggregate atol 1e-4
of the JAX protocol's result (the field quantizes each weighted delta to
steps of 2^-16 = 1.5e-5, and a delta that differs in its last bits between
the packages can round to the neighbouring step), and within the JAX test's
1e-3 of plain FedAvg; the CLIs' histories and saved models atol 1e-5 of the
JAX CLI's (the JAX CLI folds in arrival order), their byte counts equal.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import json

import jax
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import cross_silo as jsilo
from fedml_tpu.algorithms import fedavg_distributed as jfd
from fedml_tpu.algorithms import turboaggregate_dist as jta
from fedml_tpu.comm import loopback as jloopback
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.data.synthetic import gaussian_blobs
from fedml_tpu.exp import main_fedavg as jmain
from fedml_tpu.exp import main_turboaggregate as jmain_ta
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.obs.checkpoint import load_params as jax_load_params
from fedml_tpu.sim.cohort import FederatedArrays as JaxArrays
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import cross_silo as tsilo
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.algorithms import turboaggregate_dist as tta
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.core.trainer import ClientTrainer, make_local_train, sgd
from fedml_tpu_torch.data.registry import load_partition_data
from fedml_tpu_torch.exp import main_fedavg as tmain
from fedml_tpu_torch.exp import main_turboaggregate as tmain_ta
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.obs import checkpoint
from fedml_tpu_torch.sim.cohort import FederatedArrays, stack_cohort
from tests.test_torch_fedavg_dist import _assert_close_to_jax, _within_deadline


def _pair(lr=0.3, epochs=1):
    return (JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(lr), epochs=epochs),
            ClientTrainer(module=LogisticRegression(num_classes=4, in_features=16, device="cpu"),
                          optimizer=sgd(lr), epochs=epochs))


def _start_from(monkeypatch, module, jax_template):
    """Make ``module``'s ``init_template`` graft the JAX run's initial
    variables over the port's fresh ones."""
    def init_template(trainer, arrays, batch_size, seed=0, init_overrides=None):
        return tfd.init_template(trainer, arrays, batch_size, seed,
                                 init_overrides=convert.from_flax(jax_template))

    monkeypatch.setattr(module, "init_template", init_template)


# -- cross-silo -------------------------------------------------------------------


def _silos():
    train, _ = gaussian_blobs(n_clients=2, samples_per_client=48, num_classes=4, seed=9)
    jax_silos, port_silos = [], []
    for s in range(2):
        idx = train.partition[s]
        arrays = {k: v[idx] for k, v in train.arrays.items()}
        jax_silos.append(JaxArrays(arrays, {0: np.arange(len(idx))}))
        port_silos.append(FederatedArrays(arrays, {0: np.arange(len(idx))}))
    return jax_silos, port_silos


def test_cross_silo_matches_jax(monkeypatch):
    (jtr, ttr), (jsilos, tsilos) = _pair(epochs=2), _silos()
    jfab, tfab = jloopback.LoopbackFabric(3), tloopback.OrderedUplinkFabric(
        3, 2, tfd.MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER)
    jfinal = _within_deadline(lambda: jsilo.run_cross_silo(
        jtr, jsilos, 3, 16, lambda r: jloopback.LoopbackCommManager(jfab, r)), [jfab])
    template, _, _ = jfd.init_template(jtr, jsilos[0].arrays, 16, 0)
    _start_from(monkeypatch, tsilo, template)
    rounds = []
    tfinal = _within_deadline(lambda: tsilo.run_cross_silo(
        ttr, tsilos, 3, 16, lambda r: tloopback.LoopbackCommManager(tfab, r),
        silo_meshes=[torch.device("cpu")] * 2,
        on_round_done=lambda r, v: rounds.append(r)), [tfab])
    assert rounds == [0, 1, 2]
    _assert_close_to_jax(jax.tree.map(np.asarray, jfinal), tfinal, atol=1e-5)


def test_a_silo_over_several_devices_is_refused():
    _, ttr = _pair()
    with pytest.raises(NotImplementedError, match="ROADMAP §A12"):
        tsilo.make_silo_local_train(ttr, ["cpu", "cpu"])


# -- TurboAggregate ---------------------------------------------------------------

WORKERS, BATCH = 4, 10


def _drop(base, types):
    class Drop(base):
        def send_message(self, msg):
            if msg.get_type() in types:
                return
            super().send_message(msg)

    return Drop


CASES = {
    # name: (types the last rank never sends, rounds, run kwargs)
    "plain": ((), 2, {}),
    "dropped_uploader": ((jta.TAMessage.MSG_TYPE_C2S_SHARE_SUM,), 2, {"round_timeout": 0.5}),
    "pre_share_drop": ((jta.TAMessage.MSG_TYPE_C2C_SHARE, jta.TAMessage.MSG_TYPE_C2S_SHARE_SUM,
                        jta.TAMessage.MSG_TYPE_C2S_SHARE_REPORT), 1,
                       {"round_timeout": 1.5, "share_timeout": 0.5, "threshold": 1}),
}


def _ta_run(run, loopback, trainer, train, case):
    types, rounds, kw = CASES[case]
    fabric = loopback.LoopbackFabric(WORKERS + 1)
    drop = _drop(loopback.LoopbackCommManager, set(types))

    def make_comm(r):
        return (drop if types and r == WORKERS else loopback.LoopbackCommManager)(fabric, r)

    return _within_deadline(
        lambda: run(trainer, train, WORKERS, rounds, BATCH, make_comm, seed=0, **kw), [fabric])


def _open_fedavg(trainer, data, template, exclude=()):
    """One round of weighted FedAvg over the non-excluded ranks with the
    protocol's batches, on the port's trainer."""
    local_train = make_local_train(trainer)
    models, ns = [], []
    for rank in range(1, WORKERS + 1):
        if rank in exclude:
            continue
        batches, weights = stack_cohort(data, np.asarray([(rank - 1) % data.num_clients]),
                                        BATCH, rng=np.random.RandomState(1000))
        new, _ = local_train(template, {k: torch.from_numpy(v[0]) for k, v in batches.items()})
        models.append(new)
        ns.append(float(weights[0]))
    w = np.asarray(ns) / sum(ns)
    return {k: sum(float(wi) * m[k] for wi, m in zip(w, models)) for k in template}


@pytest.mark.parametrize("case", sorted(CASES))
def test_turboaggregate_matches_jax(monkeypatch, case):
    train, _ = gaussian_blobs(n_clients=WORKERS, samples_per_client=30, num_classes=4, seed=2)
    tdata = FederatedArrays(train.arrays, train.partition)
    jtr, ttr = _pair()
    jfinal = _ta_run(jta.run_turboaggregate, jloopback, jtr, train, case)
    template, _, _ = jfd.init_template(jtr, train.arrays, BATCH, 0)
    _start_from(monkeypatch, tta, template)
    tfinal = _ta_run(tta.run_turboaggregate, tloopback, ttr, tdata, case)
    _assert_close_to_jax(jax.tree.map(np.asarray, jfinal), tfinal, atol=1e-4)
    if CASES[case][1] == 1:
        # secure aggregate == open FedAvg over the contributors (the JAX
        # test's 1e-3)
        exclude = (WORKERS,) if case == "pre_share_drop" else ()
        expected = _open_fedavg(ttr, tdata, convert.from_flax(template), exclude)
        for k, v in expected.items():
            np.testing.assert_allclose(tfinal[k].numpy(), v.numpy(), atol=1e-3)


def test_turboaggregate_rejects_non_f32_leaves(monkeypatch):
    _, ttr = _pair()
    train, _ = gaussian_blobs(n_clients=WORKERS, samples_per_client=10, num_classes=4, seed=2)
    ttr.module.double()
    with pytest.raises(ValueError, match="float32"):
        tta.run_turboaggregate(ttr, FederatedArrays(train.arrays, train.partition), WORKERS, 1,
                               BATCH, lambda r: None)


def test_main_turboaggregate_matches_the_jax_cli(monkeypatch):
    from fedml_tpu.data import load_partition_data as jax_data
    from fedml_tpu.models import create_model as jax_model

    ds = jax_data("synthetic", None, "homo", 0.5, 4, 0)
    jtr = JaxTrainer(module=jax_model("lr", ds.class_num, "synthetic"), optimizer=optax.sgd(0.1))
    template, _, _ = jfd.init_template(jtr, ds.train.arrays, 16, 0)
    jout = jmain_ta.main([])
    _start_from(monkeypatch, tta, template)
    tout = tmain_ta.main(["--device", "cpu"])
    assert tout["rounds"] == jout["rounds"]
    assert tout["test_acc"] == pytest.approx(jout["test_acc"], abs=1e-6)
    # over the shm rings: the same protocol, the same result
    shm = tmain_ta.main(["--device", "cpu", "--backend", "shm"])
    assert shm["test_acc"] == pytest.approx(jout["test_acc"], abs=1e-6)


# -- main_fedavg --backend loopback -----------------------------------------------

BASE = ["--dataset", "synthetic", "--backend", "loopback", "--comm_round", "2",
        "--client_num_in_total", "4", "--client_num_per_round", "4",
        "--frequency_of_the_test", "1", "--batch_size", "16"]


@pytest.fixture(scope="module")
def init_file(tmp_path_factory):
    """Initial variables both CLIs start from (``--init_from``), written by
    the port in the JAX layout."""
    ds = load_partition_data("synthetic", None, "hetero", 0.5, 4, 0)
    model = create_model("lr", ds.class_num, "synthetic", device="cpu",
                         input_shape=tuple(ds.train.arrays["x"].shape[1:]))
    trainer = ClientTrainer(module=model)
    path = tmp_path_factory.mktemp("init") / "init.npz"
    checkpoint.save_params(path, tfd.init_template(trainer, ds.train.arrays, 16, 7)[0])
    return str(path)


@pytest.mark.parametrize("extra", [
    [], ["--algorithm", "fedprox"], ["--compressor", "topk", "--topk_frac", "0.1"],
    ["--is_mobile", "1"], ["--send_retries", "2"],
], ids=["fedavg", "fedprox", "topk", "mobile", "retries"])
def test_main_fedavg_loopback_matches_the_jax_cli(tmp_path, init_file, extra):
    argv = BASE + ["--init_from", init_file] + extra
    jfinal = jmain.main(argv + ["--save_params_to", str(tmp_path / "jax.npz")])
    tfinal = tmain.main(argv + ["--device", "cpu", "--save_params_to",
                                str(tmp_path / "port.npz")])
    assert jfinal.keys() == tfinal.keys()
    for k, v in jfinal.items():
        if k.startswith("Comm/") or k == "round":
            assert tfinal[k] == v, k
        else:
            assert tfinal[k] == pytest.approx(v, abs=1e-5), k
    _assert_close_to_jax(jax_load_params(tmp_path / "jax.npz"),
                         checkpoint.load_params(tmp_path / "port.npz"), atol=1e-5)


def test_main_fedavg_loopback_checkpoint_resume_and_fleet_stats(tmp_path, init_file):
    argv = BASE + ["--init_from", init_file, "--device", "cpu"]
    whole = tmain.main(argv + ["--comm_round", "3", "--save_params_to",
                               str(tmp_path / "whole.npz")])
    ckpt = ["--checkpoint_dir", str(tmp_path / "ckpt"), "--checkpoint_every", "1"]
    tmain.main(argv + ckpt)
    resumed = tmain.main(argv + ckpt + ["--comm_round", "3", "--resume", "1",
                                        "--save_params_to", str(tmp_path / "resumed.npz")])
    assert resumed["round"] == whole["round"] == 2
    a, b = (checkpoint.load_params(tmp_path / f) for f in ("whole.npz", "resumed.npz"))
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=0, atol=1e-6)
    fleet = tmp_path / "fleet"
    tmain.main(argv + ["--fleet_stats", str(fleet), "--run_dir", str(tmp_path / "run")])
    lines = (fleet / "fleet.jsonl").read_text().splitlines()
    assert [json.loads(x)["round"] for x in lines] == [0, 1]
    assert json.loads((fleet / "fleet.json").read_text())["rounds_recorded"] == 2


@pytest.mark.parametrize("flags, item", [
    (["--server_mode", "async", "--downlink_compressor", "q8"], "§A11.4"),
    (["--downlink_keyframe_every", "4"], "§A11.4"), (["--downlink_retention", "2"], "§A11.4"),
    (["--downlink_compressor", "q8"], "§A11.4"),
], ids=lambda v: v if isinstance(v, str) else "_".join(v).strip("-"))
def test_unported_wire_flags_raise_naming_their_roadmap_item(tmp_path, init_file, flags, item):
    """The downlink flags (ROADMAP ``item``) are ported: the port's final
    record has the JAX CLI's keys and its ``Comm/*`` byte counts. Without a
    codec the tuning flags tune nothing, and every value matches at 1e-5 as
    in ``test_main_fedavg_loopback_matches_the_jax_cli``; with a q8 codec the
    quantizer draws other uniforms than JAX's (ROADMAP §C), so the other
    values are only held finite."""
    argv = BASE + ["--init_from", init_file] + flags
    want = jmain.main(argv)
    got = tmain.main(argv + ["--device", "cpu"])
    assert got.keys() == want.keys()
    coded = "--downlink_compressor" in flags
    for k, v in want.items():
        if k.startswith("Comm/") or k == "round":
            assert got[k] == v, k
        elif coded:
            assert np.isfinite(got[k]), k
        else:
            assert got[k] == pytest.approx(v, abs=1e-5), k
    assert coded == any(k.startswith("Comm/Downlink") for k in got)
