"""The port's dispatch and staging plane (fedml_tpu_torch.sim.engine): the
defaults' rule, the dispatch plan, block dispatch (eval-aligned blocks of
rounds; on the CPU a block runs its rounds one after another), host staging
(``stage_on_device=False``) and the device-side masked scan-mode loop,
against the per-round loop, the on-device path and the JAX engine.

Tolerances:
- the defaults' rule and the dispatch plan: exact;
- a block against the per-round loop, a pipelined block run against a
  serial one, host staging against on-device staging, the masked scan loop
  against the skipping loop it replaced: bitwise (the same arithmetic on
  the same values in the same order: staging is a pure function of (seed,
  round), and zero-filled padding enters only masked sums);
- the port against the JAX engine (``block_dispatch=True``, and
  ``stage_on_device=False``), from the same converted variables: atol 1e-5
  on parameters, round losses and eval metrics, as the LR and LeNet parity
  tests hold them (a few f32 SGD steps summed in other orders).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.core.trainer import (ClientTrainer, _augmented, _last_epoch, adam,
                                          make_local_train, sgd)
from fedml_tpu_torch.data.synthetic import gaussian_blobs
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig, resolve_dispatch

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The file's CNN rounds on one torch thread: beside the suite's other
    workers, a thread per core oversubscribes the CPU and the convolutions
    slow down 50-80x (measured under the 6-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs():
    return gaussian_blobs(n_clients=6, samples_per_client=24, num_classes=4, dim=16,
                          partition_method="hetero", partition_alpha=0.5, seed=0)


def _sim(model="lr", train=None, test=None, **cfg_kw):
    if train is None:
        train, test = _blobs()
    if model == "cnn":  # CNNDropOut on 28 x 28 images: dropout masks in every step
        rng = np.random.RandomState(1)
        train = FederatedArrays({"x": rng.rand(train.num_samples, 28, 28).astype(np.float32),
                                 "y": train.arrays["y"]}, train.partition)
        test = {"x": rng.rand(len(test["y"]), 28, 28).astype(np.float32), "y": test["y"]}
    module = create_model(model, 4, "femnist", device="cpu",
                          input_shape=train.arrays["x"].shape[1:])
    trainer = ClientTrainer(module=module, optimizer=sgd(0.2, momentum=0.5), epochs=2)
    cfg = dict(client_num_in_total=6, client_num_per_round=4, batch_size=8, comm_round=6,
               epochs=2, frequency_of_the_test=3, eval_batch_size=16, seed=0,
               straggler_frac=0.5)
    cfg.update(cfg_kw)
    return FedSim(trainer, train, test, SimConfig(**cfg), device="cpu")


def _equal_vars(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _strip(history):
    return [{k: v for k, v in rec.items() if k != "round_time"} for rec in history]


# -- the defaults' rule (fedml_tpu/sim/engine.py:681-691) --------------------

_SMALL, _HUGE = 1 << 20, (2 << 30) + 4096
_FLAGS = [(s, b) for s in (None, True, False) for b in (None, True, False)]


def _jax_rule(nbytes, platform, stage_on_device, block_dispatch):
    """The JAX engine's lines 681-691, for a platform this machine cannot
    give a live JAX FedSim (packed lanes and sharded rounds off)."""
    on = stage_on_device if stage_on_device is not None else nbytes <= 2 << 30
    block = (block_dispatch if block_dispatch is not None
             else on and platform != "cpu") and on
    return on, bool(block)


@pytest.mark.parametrize("platform", ["cuda", "tpu"])
@pytest.mark.parametrize("nbytes", [_SMALL, _HUGE])
@pytest.mark.parametrize("stage_on_device,block_dispatch", _FLAGS)
def test_dispatch_rule_matches_jax_table(platform, nbytes, stage_on_device, block_dispatch):
    cfg = SimConfig(stage_on_device=stage_on_device, block_dispatch=block_dispatch)
    assert resolve_dispatch(cfg, nbytes, platform) == _jax_rule(
        nbytes, platform, stage_on_device, block_dispatch)


def _broadcast_blobs(rows):
    """A dataset of ``rows`` rows whose arrays report their full size but
    hold one row (zero-stride views), over two clients of 8 samples."""
    rng = np.random.RandomState(0)
    arrays = {"x": np.broadcast_to(rng.rand(1, 4).astype(np.float32), (rows, 4)),
              "y": np.broadcast_to(np.zeros(1, np.int32), (rows,))}
    if rows * 4 * 5 <= 2 << 30:  # small enough to hold: writable copies
        arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    part = {0: np.arange(8), 1: np.arange(8, 16)}
    test = {"x": rng.rand(8, 4).astype(np.float32), "y": np.zeros(8, np.int32)}
    return arrays, part, test


@pytest.mark.parametrize("huge,stage_on_device,block_dispatch", [
    (huge, s, b) for huge in (False, True) for s, b in _FLAGS
    if not (huge and s)])  # that would copy the 2 GiB to the device
def test_dispatch_rule_matches_live_jax_engine_on_cpu(huge, stage_on_device, block_dispatch):
    """Both engines built on the CPU, training arrays of 2 GiB + 8 bytes
    (huge, zero-stride views: nothing of that size is allocated) or of a
    few kilobytes."""
    arrays, part, test = _broadcast_blobs(2 ** 27 + 1 if huge else 64)
    kw = dict(client_num_in_total=2, client_num_per_round=2, batch_size=4, comm_round=1,
              seed=0, train_eval_samples=8, stage_on_device=stage_on_device,
              block_dispatch=block_dispatch)
    jsim = JaxSim(JaxTrainer(module=JaxLR(num_classes=2), optimizer=optax.sgd(0.1)),
                  jcohort.FederatedArrays(arrays, part), test, JaxConfig(**kw))
    tsim = FedSim(ClientTrainer(module=create_model("lr", 2, device="cpu", input_shape=(4,))),
                  FederatedArrays(arrays, part), test, SimConfig(**kw), device="cpu")
    nbytes = sum(a.nbytes for a in arrays.values())
    assert (nbytes > 2 << 30) == huge
    assert (tsim._on_device, tsim._block_dispatch) == (jsim._on_device,
                                                           jsim._block_dispatch)
    assert (tsim._dataset is not None) == tsim._on_device


# -- the dispatch plan (fedml_tpu/sim/engine.py:2041-2061) --------------------


@pytest.fixture(scope="module")
def plan_sims():
    train, test = _blobs()
    kw = dict(client_num_in_total=6, client_num_per_round=4, batch_size=8, seed=0)
    jsim = JaxSim(JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(0.2)),
                  jcohort.FederatedArrays(train.arrays, train.partition), test,
                  JaxConfig(**kw))
    return jsim, _sim(train=train, test=test)


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("start,comm_round,freq,profile_dir", [
    (0, 20, 10, None), (0, 20, 10, "prof"), (3, 20, 10, None), (3, 20, 10, "prof"),
    (0, 7, 3, None), (5, 7, 3, "prof"), (0, 6, 1, None), (0, 5, 0, None), (0, 6, 100, None),
    (6, 6, 2, None), (11, 25, 4, "prof"),
])
def test_dispatch_plan_matches_jax(plan_sims, block, start, comm_round, freq, profile_dir):
    jsim, tsim = plan_sims
    change = dict(comm_round=comm_round, frequency_of_the_test=freq, profile_dir=profile_dir)
    jsim.config = dataclasses.replace(jsim.config, **change)
    tsim.config = dataclasses.replace(tsim.config, **change)
    jsim._block_dispatch = tsim._block_dispatch = block
    plan = tsim._dispatch_plan(start)
    assert plan == jsim._dispatch_plan(start)
    assert sum(n for _, n in plan) == max(comm_round - start, 0)


# -- block dispatch: the port of tests/test_device_staging.py:33-62 ----------


@pytest.mark.parametrize("model,mode", [("lr", "vmap"), ("lr", "scan"), ("cnn", "vmap"),
                                        ("cnn", "scan")])
def test_run_block_equals_per_round_loop(model, mode):
    """R rounds as one block equal R rounds dispatched one at a time,
    bitwise (stragglers, momentum; the CNN's dropout masks drawn alike)."""
    sim1 = _sim(model, cohort_execution=mode)
    v = sim1.init_round_variables()
    s = sim1.aggregator.init_state(v)
    losses = []
    for r in range(6):
        v, s, m = sim1.run_round(r, v, s)
        losses.append(m["Train/Loss"])
    sim2 = _sim(model, cohort_execution=mode, block_dispatch=True)
    v2 = sim2.init_round_variables()
    v2, s2, ms = sim2.run_block(0, 6, v2, sim2.aggregator.init_state(v2))
    _equal_vars(v, v2)
    assert ms["Train/Loss"].shape == (6,)
    assert torch.equal(ms["Train/Loss"], torch.stack(losses))
    # run() blocks between the eval rounds and gives the full history
    sim3 = _sim(model, cohort_execution=mode, block_dispatch=True)
    assert sim3._dispatch_plan(0) == [(0, 3), (3, 3)]
    v3, hist = sim3.run()
    _equal_vars(v, v3)
    assert [h["round"] for h in hist] == list(range(6))
    assert ["Test/Acc" in h for h in hist] == [False, False, True, False, False, True]


@pytest.mark.parametrize("model", ["lr", "cnn"])
def test_masked_scan_round_equals_skipping_round(model):
    """The scan round a CUDA graph captures (step budgets on the device
    only, so empty and over-budget steps are masked no-ops) equals the eager
    round that skips them on the host, bitwise, for each of 3 rounds."""
    sim = _sim(model, cohort_execution="scan")
    v = sim.init_round_variables()
    for r in range(3):
        staged = sim.stage_round(r)
        eager = sim.run_staged_round(staged, v, ())
        masked = sim.round_step(dataclasses.replace(staged, num_steps_host=None), v, (),
                                sim._dropout(r, len(staged.cohort)))
        _equal_vars(eager[0], masked[0])
        assert torch.equal(eager[2]["Train/Loss"], masked[2]["Train/Loss"])
        v = eager[0]


def test_run_block_refuses_host_staging_and_a_mismatched_block():
    sim = _sim(stage_on_device=False)
    v = sim.init_round_variables()
    with pytest.raises(ValueError, match="on-device dataset"):
        sim.run_block(0, 2, v, ())
    sim = _sim(block_dispatch=True)
    with pytest.raises(ValueError, match="staged for"):
        sim.run_block(0, 2, v, (), staged=sim.stage_block(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        sim.capture_round_graph()


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_block_run_equals_serial(depth):
    """The port of tests/test_pipeline_driver.py:79: the prefetch thread
    stages the next block while the current one runs; bitwise."""
    runs = {}
    for d in (0, depth):
        sim = _sim(block_dispatch=True, pipeline_depth=d, eval_on_clients=True)
        runs[d] = sim.run()
    (v0, h0), (v1, h1) = runs[0], runs[depth]
    _equal_vars(v0, v1)
    assert [r["round"] for r in h1] == list(range(6))
    assert [set(r) for r in h1] == [set(r) for r in h0]
    assert _strip(h1) == _strip(h0)
    assert all(r["round_time"] > 0 for r in h1)


# -- the port against the JAX engine ------------------------------------------


def _against_jax(port_kw, jax_kw, rounds=4, freq=2):
    train, test = _blobs()
    kw = dict(client_num_in_total=6, client_num_per_round=4, batch_size=8, comm_round=rounds,
              epochs=2, frequency_of_the_test=freq, eval_batch_size=16, seed=0,
              straggler_frac=0.5, train_eval_samples=100)
    jsim = JaxSim(JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(0.2), epochs=2),
                  jcohort.FederatedArrays(train.arrays, train.partition), test,
                  JaxConfig(**kw, **jax_kw))
    tsim = FedSim(ClientTrainer(module=create_model("lr", 4, device="cpu", input_shape=(16,)),
                                optimizer=sgd(0.2), epochs=2),
                  train, test, SimConfig(**kw, **port_kw), device="cpu")
    j_vars = jsim.init_round_variables()
    t_vars = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    j_out, j_hist = jsim.run(variables=j_vars)
    t_out, t_hist = tsim.run(variables=t_vars)
    back = convert.to_flax(t_out)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(j_out))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=ATOL, err_msg=str(path))
    assert [r["round"] for r in t_hist] == [r["round"] for r in j_hist]
    for t_rec, j_rec in zip(t_hist, j_hist):
        keys = set(j_rec) - {"round", "round_time"}
        assert keys == set(t_rec) - {"round", "round_time"}
        for k in keys:
            assert abs(t_rec[k] - j_rec[k]) <= ATOL, (k, t_rec, j_rec)
    return tsim, jsim


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_block_run_matches_jax_block_dispatch(mode):
    tsim, jsim = _against_jax(dict(block_dispatch=True, cohort_execution=mode),
                              dict(block_dispatch=True, cohort_execution=mode))
    assert tsim._dispatch_plan(0) == jsim._dispatch_plan(0) == [(0, 2), (2, 2)]


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_host_staging_matches_jax_host_staging(mode):
    tsim, jsim = _against_jax(dict(stage_on_device=False, cohort_execution=mode),
                              dict(stage_on_device=False, cohort_execution=mode))
    assert not tsim._on_device and not jsim._on_device and tsim._dataset is None


# -- host staging against on-device staging, bitwise -------------------------


@pytest.mark.parametrize("model,mode", [("lr", "vmap"), ("lr", "scan"), ("cnn", "vmap")])
@pytest.mark.parametrize("train_eval_samples", [None, 50])
def test_host_staging_equals_on_device(model, mode, train_eval_samples):
    runs = {}
    for on in (True, False):
        sim = _sim(model, cohort_execution=mode, stage_on_device=on, eval_on_clients=True,
                   train_eval_samples=train_eval_samples, comm_round=4, frequency_of_the_test=2)
        assert sim._on_device is on and not sim._block_dispatch
        staged = sim.stage_round(1)
        assert (staged.idx is None) == (not on) and (staged.batches is None) == on
        runs[on] = (sim, sim.run())
    (sim_on, (v_on, h_on)), (sim_off, (v_off, h_off)) = runs[True], runs[False]
    _equal_vars(v_on, v_off)
    assert _strip(h_on) == _strip(h_off)
    assert "Train/AccOnClients" in h_off[-1]
    # per-client eval of a subset, and of an external data set
    for kw in ({}, {"client_ids": [5, 0, 3], "batch_size": 5, "chunk": 2}):
        a = sim_on.evaluate_per_client(v_on, **kw)
        b = sim_off.evaluate_per_client(v_on, **kw)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_evaluate_fetches_once_and_keeps_its_values():
    """The queued pooled eval gives the values of four separate fetches."""
    sim = _sim()
    v, _ = sim.run()
    out = sim.evaluate(v)
    assert list(out) == ["Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"]
    train_batches = sim._gather_batches(sim._dataset, sim._train_eval)
    expect = {f"Train/{k}": float(t) for k, t in sim._eval(v, train_batches).items()}
    expect.update({f"Test/{k}": float(t) for k, t in sim._eval(v, sim._test_batches).items()})
    assert out == expect


# -- the masked scan-mode loop against the skipping loop it replaced ---------


def _skipping_local_train(trainer):
    """The scan mode's loop before steps were masked on the device: empty
    and over-budget steps skipped on the host."""

    def local_train(global_variables, data, num_steps=None, draws=None, dropout=None, slot=0):
        trainer.module.load_state_dict(global_variables)
        optimizer = trainer.optimizer(trainer.module.parameters())
        global_params = ({k: global_variables[k] for k, _ in trainer.module.named_parameters()}
                         if trainer.prox_mu > 0.0 else None)
        S = data["mask"].shape[0]
        has_data = (data["mask"].reshape(S, -1).sum(1) > 0).tolist()
        loss_sums, w_sums = [], []
        for e in range(trainer.epochs):
            total = torch.zeros((), dtype=torch.float32)
            w = 0
            for s in range(S):
                if not has_data[s] or (num_steps is not None and e * S + s >= num_steps):
                    continue
                batch = _augmented(trainer, {k: v[s] for k, v in data.items()}, draws, e, s)
                masks = (None if not trainer.dropout_sites else
                         {k: m[slot] for k, m in dropout.masks(e * S + s).items()})
                total = total + trainer.train_step(optimizer, batch, has_data=True,
                                                   global_params=global_params, masks=masks)
                w += 1
            loss_sums.append(total)
            w_sums.append(w)
        last = _last_epoch(num_steps, S, trainer.epochs)
        trainer.module.zero_grad(set_to_none=True)
        variables = {k: v.detach().clone() for k, v in trainer.module.state_dict().items()}
        return variables, {"train_loss": loss_sums[last] / max(w_sums[last], 1)}

    return local_train


@pytest.mark.parametrize("model,optimizer", [
    ("lr", sgd(0.2)), ("lr", sgd(0.1, momentum=0.9, weight_decay=1e-3)),
    ("lr", adam(0.01, weight_decay=1e-3)), ("cnn_original", sgd(0.05, momentum=0.9)),
    ("resnet8", sgd(0.05, momentum=0.9, weight_decay=1e-3)),
])
@pytest.mark.parametrize("budget", [None, 1, 3, 5, 8])
def test_masked_scan_loop_equals_skipping_loop(model, optimizer, budget):
    """Bitwise, with empty steps (the last two of the epoch), a step budget
    that stops inside either epoch (a straggler) and FedProx's term; the
    ResNet's BatchNorm statistics are restored on a masked step too."""
    rng = np.random.RandomState(3)
    if model == "resnet8":
        from fedml_tpu_torch.models.resnet import CifarResNet

        module = CifarResNet(depth=8, num_classes=4, device="cpu")
        x = rng.randn(4, 2, 8, 8, 3).astype(np.float32)
    else:
        module = create_model(model, 4, "femnist", device="cpu",
                              input_shape=(16,) if model == "lr" else (28, 28))
        x = rng.rand(4, 2, *((16,) if model == "lr" else (28, 28))).astype(np.float32)
    mask = np.ones((4, 2), np.float32)
    mask[1, 1] = 0.0
    mask[2:] = 0.0
    data = {"x": torch.tensor(x * mask.reshape(mask.shape + (1,) * (x.ndim - 2))),
            "y": torch.tensor(rng.randint(0, 4, (4, 2)).astype(np.int32)),
            "mask": torch.tensor(mask)}
    trainer = ClientTrainer(module=module, optimizer=optimizer, epochs=2, prox_mu=0.1)
    variables = trainer.init(torch.Generator().manual_seed(0))
    outs = [make_local_train(trainer)(variables, data, budget),
            _skipping_local_train(trainer)(variables, data, budget),
            make_local_train(trainer)(variables, data,
                                      None if budget is None else torch.tensor(budget))]
    for v, m in outs[1:]:
        _equal_vars(outs[0][0], v)
        assert torch.equal(outs[0][1]["train_loss"], m["train_loss"])


# -- the repro loop (exp/_loop.py) and the CLI --------------------------------


def _loop_sim(depth, **kw):
    return _sim(pipeline_depth=depth, frequency_of_the_test=2, **kw)


def test_run_rounds_pipelined_equals_serial(tmp_path):
    """Record for record, bitwise but ``round_time``, in the file too; no
    staging thread outlives the run."""
    import json
    import threading

    from fedml_tpu_torch.exp._loop import run_rounds
    from fedml_tpu_torch.sim.prefetch import THREAD_NAME

    out = {}
    for depth in (0, 1, 2):
        sim = _loop_sim(depth)
        path = tmp_path / f"d{depth}.jsonl"
        records, wall = run_rounds(sim, sim.config, str(path))
        assert [json.loads(line) for line in path.read_text().splitlines()] == records
        assert wall > 0 and all(r["round_time"] > 0 for r in records)
        out[depth] = _strip(records)
    assert [r["round"] for r in out[0]] == list(range(6))
    assert out[1] == out[0] and out[2] == out[0]
    assert not any(t.name == THREAD_NAME for t in threading.enumerate())


@pytest.mark.parametrize("depth", [0, 1])
def test_run_rounds_stop_sentinel(tmp_path, depth):
    """A sentinel found after a round stops the run there and is consumed; a
    stale one is cleared before the first round."""
    from fedml_tpu_torch.exp._loop import run_rounds

    metrics = tmp_path / "m.jsonl"
    stop = tmp_path / "m.jsonl.stop"
    stop.touch()  # stale: must not cut the run
    sim = _loop_sim(depth)
    records, _ = run_rounds(sim, sim.config, str(metrics))
    assert [r["round"] for r in records] == list(range(6)) and not stop.exists()
    sim = _loop_sim(depth)
    original = sim.run_staged_round

    def touch_at_round_2(staged, *args):
        if staged.round_idx == 2:
            stop.touch()
        return original(staged, *args)

    sim.run_staged_round = touch_at_round_2
    records, _ = run_rounds(sim, sim.config, str(metrics))
    assert [r["round"] for r in records] == [0, 1, 2] and not stop.exists()
    assert len(metrics.read_text().splitlines()) == 3


@pytest.mark.parametrize("depth", [0, 1])
def test_run_rounds_salvages_completed_rounds(tmp_path, depth):
    """Staging that fails at round 3 (after round 1's eval) keeps rounds 0-2;
    an eval that fails at round 3 (eval every 4) keeps rounds 0-2 too: the
    pipelined loop writes completed rounds before the eval."""
    from fedml_tpu_torch.exp._loop import run_rounds

    sim = _loop_sim(depth)
    original = sim.stage_round

    def boom(r):
        if r >= 3:
            raise RuntimeError("staging failed")
        return original(r)

    sim.stage_round = boom
    records, _ = run_rounds(sim, sim.config, str(tmp_path / "a.jsonl"))
    assert [r["round"] for r in records] == [0, 1, 2]
    sim = _sim(pipeline_depth=depth, frequency_of_the_test=4)

    def failing_eval(variables):
        raise RuntimeError("eval failed")

    sim.eval_record = failing_eval
    records, _ = run_rounds(sim, sim.config, str(tmp_path / "b.jsonl"))
    assert [r["round"] for r in records] == [0, 1, 2]


def test_cli_host_staging_equals_on_device(tmp_path):
    """``main_fedavg --stage_on_device 0`` and ``1``: the same history."""
    import argparse

    from fedml_tpu_torch.exp import main_fedavg as cli

    histories = {}
    for flag in ("0", "1", "-1"):
        args = cli.parse_with_config(cli.add_args(argparse.ArgumentParser()), [
            "--dataset", "synthetic", "--client_num_in_total", "6", "--client_num_per_round",
            "3", "--comm_round", "4", "--frequency_of_the_test", "2", "--epochs", "2",
            "--eval_on_clients", "1", "--stage_on_device", flag, "--device", "cpu"])
        histories[flag] = _strip(cli.run(args))
    assert len(histories["0"]) == 4 and "Test/Acc" in histories["0"][-1]
    assert histories["0"] == histories["1"] == histories["-1"]
