"""Decentralized gossip in the port (``algorithms/decentralized.py``,
``topology/topology.py``, the engine's per-client mode) and the ``poison``
copy, against the JAX package's, on the same numpy-made inputs.

Tolerances:

- the topology and poison copies (pure numpy): bitwise;
- ``mix`` and ``gossip_aggregator`` (``consensus_dist`` included) on the
  same stacks, mesh-padding identity rows included: atol 1e-6 (f32 matmul
  and sums in other orders);
- FedSim in the per-client mode, 8 clients on a ring, 3 rounds, vmap and
  scan, from the same converted initial variables: every client's model,
  the round loss and ``consensus_dist`` atol 1e-5 each round against the
  JAX engine (8 clients fill its 8-device CPU mesh, so no slot is padded),
  and the eval record's consensus model the same;
- a complete graph (all 1/N) over equal clients: every client's model
  after one round equals the unweighted FedAvg round's global model at
  atol 1e-6;
- the refusals: the JAX engine's exception types and messages;
- DSGD and Push-Sum steps, and ``run_online_gossip`` over 6 steps in
  either mode (Push-Sum on the time-varying graph): atol 1e-6;
- a per-client run stopped after round 2 and resumed from its checkpoint
  (the ``[N, ...]`` stack) to round 4, through the CLI: bitwise the
  uninterrupted run's history and saved consensus model.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import decentralized as jdec
from fedml_tpu.compress import codec as jcodec
from fedml_tpu.compress.aggregate import compressed_aggregator as jax_compressed
from fedml_tpu.core import rng as jrng
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.data import poison as jpoison
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu.topology import topology as jtopo
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import decentralized
from fedml_tpu_torch.algorithms.base import fedavg_aggregator
from fedml_tpu_torch.compress import codec
from fedml_tpu_torch.compress.aggregate import compressed_aggregator
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.data import poison
from fedml_tpu_torch.data.synthetic import gaussian_blobs
from fedml_tpu_torch.exp import main_fedavg as port_cli
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig
from fedml_tpu_torch.topology import topology

ATOL = 1e-5


@pytest.mark.parametrize("n,k,seed", [(8, 2, 0), (7, 4, 3), (12, 5, 1), (3, 2, 0)])
def test_topology_copies_are_bitwise(n, k, seed):
    for make in (lambda m: m.SymmetricTopologyManager(n, k, seed),
                 lambda m: m.AsymmetricTopologyManager(n, k, 2, seed)):
        ours, theirs = make(topology), make(jtopo)
        np.testing.assert_array_equal(ours.generate_topology(), theirs.generate_topology())
        np.testing.assert_array_equal(ours.mixing_matrix(), theirs.mixing_matrix())
        for i in range(n):
            for q in ("in_neighbor_idx_list", "out_neighbor_idx_list", "in_neighbor_weights",
                      "out_neighbor_weights"):
                assert getattr(ours, f"get_{q}")(i) == getattr(theirs, f"get_{q}")(i)
    np.testing.assert_array_equal(topology.ring_topology(n), jtopo.ring_topology(n))
    for r in range(3):
        np.testing.assert_array_equal(topology.time_varying_directed(n, r),
                                      jtopo.time_varying_directed(n, r))


def test_poison_copy_is_bitwise(rng):
    n = 60
    arrays = {"x": rng.rand(n, 6, 6, 1).astype(np.float32), "y": rng.randint(0, 5, n)}
    part = {0: np.arange(0, 25), 1: np.arange(25, 26), 2: np.arange(26, 26),
            3: np.arange(26, 60)}
    flat = {"x": rng.rand(n, 9).astype(np.float32), "y": arrays["y"].copy()}
    for data in (arrays, flat):
        for kw in ({}, {"compromised_frac": 1.0, "sample_frac": 1.0, "target_label": 3,
                        "seed": 4}, {"trigger": (2, 0.5, "tl")}):
            trig = kw.pop("trigger", None)
            jkw, tkw = dict(kw), dict(kw)
            if trig:
                jkw["trigger"], tkw["trigger"] = jpoison.Trigger(*trig), poison.Trigger(*trig)
            ours = poison.poison_clients(FederatedArrays(data, part), **tkw)
            theirs = jpoison.poison_clients(jcohort.FederatedArrays(data, part), **jkw)
            for k in data:
                np.testing.assert_array_equal(ours[0].arrays[k], theirs[0].arrays[k])
            np.testing.assert_array_equal(ours[1], theirs[1])
            assert ours[2] == theirs[2]
        for kw in ({}, {"target_label": 2}):
            ours, theirs = (m.backdoor_test_arrays(data, **kw) for m in (poison, jpoison))
            for k in data:
                np.testing.assert_array_equal(ours[k], theirs[k])
                assert ours[k].dtype == theirs[k].dtype


def _flax_tree(rng, lead=()):
    def r(*shape):
        return rng.randn(*lead, *shape).astype(np.float32)

    return {"params": {"Dense_0": {"kernel": r(5, 3), "bias": r(3)}},
            "batch_stats": {"BatchNorm_0": {"mean": r(3)}}}


def _port_stack(stacked, c):
    per = [convert.from_flax(jax.tree.map(lambda a: a[i], stacked)) for i in range(c)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def _close_stack(j_stack, t_stack, c, atol):
    for i in range(c):
        back = convert.to_flax({k: v[i] for k, v in t_stack.items()})
        for path, leaf in jax.tree_util.tree_flatten_with_path(dict(j_stack))[0]:
            node = back
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(node, np.asarray(leaf)[i], atol=atol,
                                       err_msg=f"client {i} {path}")


@pytest.mark.parametrize("c", [6, 8])  # 8: two identity rows past the 6-matrix
def test_mix_and_gossip_aggregator_match_jax(rng, c):
    W = topology.SymmetricTopologyManager(6, 4, 2).generate_topology()
    stacked = _flax_tree(rng, lead=(c,))
    jstack = jax.tree.map(jnp.asarray, stacked)
    if c == 6:
        _close_stack(jdec.mix(jstack, jnp.asarray(W)),
                     decentralized.mix(_port_stack(stacked, c), torch.as_tensor(W)), c, 1e-6)
    jagg, tagg = jdec.gossip_aggregator(W), decentralized.gossip_aggregator(W)
    assert (tagg.per_client, tagg.num_clients, tagg.name) == (True, 6, "gossip")
    want, _, jm = jagg.aggregate(None, jstack, jnp.ones(c), (), None)
    got, _, tm = tagg.aggregate(None, _port_stack(stacked, c), torch.ones(c), ())
    _close_stack(want, got, c, 1e-6)
    assert set(tm) == set(jm) == {"consensus_dist"}
    np.testing.assert_allclose(float(tm["consensus_dist"]), float(jm["consensus_dist"]),
                               rtol=1e-6)


def _blobs(n_clients=8, method="hetero"):
    return gaussian_blobs(n_clients=n_clients, samples_per_client=24, num_classes=4, dim=8,
                          partition_method=method, partition_alpha=0.5, seed=1)


def _cfg(n=8, **kw):
    return dict(dict(client_num_in_total=n, client_num_per_round=n, batch_size=8, comm_round=3,
                     epochs=1, frequency_of_the_test=3, eval_batch_size=16, seed=2), **kw)


def _port_sim(train, test, W=None, **kw):
    module = create_model("lr", 4, "synthetic", device="cpu", input_shape=(8,))
    agg = decentralized.gossip_aggregator(W if W is not None else topology.ring_topology(8))
    return FedSim(ClientTrainer(module=module, optimizer=sgd(0.2)), train, test,
                  SimConfig(**kw), aggregator=agg, device="cpu")


def _jax_sim(train, test, W=None, **kw):
    return JaxSim(JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(0.2)),
                  jcohort.FederatedArrays(train.arrays, train.partition), test, JaxConfig(**kw),
                  aggregator=jdec.gossip_aggregator(
                      W if W is not None else jtopo.ring_topology(8)))


def test_per_client_rounds_match_jax_in_vmap_and_scan():
    train, test = _blobs()
    kw = _cfg()
    jsim = _jax_sim(train, test, **kw)
    j_vars = jsim.init_round_variables()
    # every row of the JAX engine's stack holds its one init
    first = convert.from_flax(jax.tree.map(lambda a: np.asarray(a)[0], dict(j_vars)))
    root = jrng.root_key(kw["seed"])
    j_hist = []
    for r in range(kw["comm_round"]):
        j_vars, _, j_m = jsim.run_round(r, j_vars, (), root)
        j_hist.append((jax.tree.map(np.asarray, dict(j_vars)),
                       {k: float(v) for k, v in j_m.items()}))
    j_eval = jsim.evaluate(jsim.consensus(j_vars))
    for mode in ("vmap", "scan"):
        sim = _port_sim(train, test, **kw, cohort_execution=mode)
        init = sim.init_round_variables()
        assert tuple(init["dense_0.bias"].shape) == (8, 4)
        assert all(torch.equal(v[i], v[0]) for v in init.values() for i in range(8))
        t_vars = {k: first[k].unsqueeze(0).repeat((8,) + (1,) * first[k].dim()) for k in first}
        for r in range(kw["comm_round"]):
            assert sim.stage_round(r).cohort.tolist() == list(range(8))
            t_vars, _, t_m = sim.run_round(r, t_vars, ())
            want_vars, want_m = j_hist[r]
            _close_stack(want_vars, t_vars, 8, ATOL)
            assert set(t_m) == set(want_m) == {"Train/Loss", "consensus_dist"}
            for k in want_m:
                np.testing.assert_allclose(float(t_m[k]), want_m[k], atol=ATOL,
                                           err_msg=f"{mode} round {r} {k}")
        got_eval = sim.evaluate(sim.consensus(t_vars))
        for k in j_eval:
            np.testing.assert_allclose(got_eval[k], j_eval[k], atol=ATOL, err_msg=k)


def test_complete_graph_equals_an_unweighted_fedavg_round():
    train, test = _blobs(n_clients=4, method="homo")
    assert len(set(train.client_sizes().tolist())) == 1
    W = np.full((4, 4), 0.25, np.float32)
    kw = _cfg(n=4, comm_round=1)
    sim = _port_sim(train, test, W=W, **kw)
    stack, _ = sim.run()
    module = create_model("lr", 4, "synthetic", device="cpu", input_shape=(8,))
    fedavg = FedSim(ClientTrainer(module=module, optimizer=sgd(0.2)), train, test,
                    SimConfig(**kw), aggregator=fedavg_aggregator(), device="cpu")
    avg, _ = fedavg.run()
    for k, v in avg.items():
        for i in range(4):
            torch.testing.assert_close(stack[k][i], v, atol=1e-6, rtol=0)


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return type(e), str(e)
    return None


REFUSALS = {
    "partial_participation": (dict(client_num_per_round=4), None),
    "topology_mismatch": ({}, 6),
    "packing": (dict(pack_lanes=2), None),
    "population": (dict(population="speed=const:1;avail=0.9"), None),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    train, test = _blobs()
    extra, n_matrix = REFUSALS[case]
    W = None if n_matrix is None else jtopo.ring_topology(n_matrix)
    kw = _cfg(**extra)
    want = _error(lambda: _jax_sim(train, test, W=W, **kw))
    got = _error(lambda: _port_sim(train, test, W=W, **kw))
    assert want is not None and got == want


def test_compression_over_a_per_client_rule_is_refused():
    train, test = _blobs()
    W = topology.ring_topology(8)
    want = _error(lambda: _jax_sim(train, test, **_cfg(compressor="topk")))
    got = _error(lambda: _port_sim(train, test, **_cfg(compressor="topk")))
    assert want is not None and got == want
    want = _error(lambda: jax_compressed(jcodec.make_codec("q8"), jdec.gossip_aggregator(W),
                                         error_feedback=False))
    got = _error(lambda: compressed_aggregator(codec.make_codec("q8"),
                                               decentralized.gossip_aggregator(W),
                                               error_feedback=False))
    assert want is not None and got == want


def _cli(tmp_path, ckpt, rounds, *extra):
    argv = ["--dataset", "synthetic_0.5_0.5", "--algorithm", "decentralized",
            "--client_num_in_total", "6", "--client_num_per_round", "2", "--comm_round",
            str(rounds), "--frequency_of_the_test", "2", "--batch_size", "8",
            "--data_dir", str(tmp_path / "none"), "--device", "cpu",
            "--checkpoint_dir", str(tmp_path / ckpt), "--checkpoint_every", "1",
            "--save_params_to", str(tmp_path / f"{ckpt}{rounds}"), *extra]
    args = port_cli.parse_with_config(port_cli.add_args(argparse.ArgumentParser()), argv)
    return port_cli.run(args)


def test_cli_decentralized_runs_every_client_and_resumes_bitwise(tmp_path, monkeypatch):
    seen = []
    original = FedSim.__init__

    def recording(self, trainer, train_data, test_arrays, config, aggregator=None, **kw):
        seen.append((config.client_num_per_round, aggregator.name, aggregator.num_clients))
        original(self, trainer, train_data, test_arrays, config, aggregator=aggregator, **kw)

    monkeypatch.setattr(FedSim, "__init__", recording)
    straight = _cli(tmp_path, "a", 4)
    assert seen[0] == (6, "gossip", 6)  # every client, every round
    assert all("consensus_dist" in rec for rec in straight)
    assert "Test/Acc" in straight[1] and np.isfinite(straight[-1]["Train/Loss"])
    _cli(tmp_path, "b", 2)
    resumed = _cli(tmp_path, "b", 4, "--resume", "1")
    assert resumed == straight
    a, b = np.load(tmp_path / "a4.npz"), np.load(tmp_path / "b4.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_dsgd_and_pushsum_steps_match_jax(rng):
    n, d = 6, 4
    p = rng.randn(n, d).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    y = np.where(rng.rand(n) > 0.5, 1.0, -1.0).astype(np.float32)
    omega = rng.rand(n).astype(np.float32) + 0.5
    W = topology.ring_topology(n)
    Wc = topology.time_varying_directed(n, 3)
    t = torch.from_numpy
    want = jax.jit(jdec.dsgd_online_step)(p, x, y, W, 0.1)
    got = decentralized.dsgd_online_step(t(p), t(x), t(y), t(W), 0.1)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    want = jax.jit(jdec.pushsum_online_step)(p, omega, x, y, Wc, 0.1)
    got = decentralized.pushsum_online_step(t(p), t(omega), t(x), t(y), t(Wc), 0.1)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    xs = rng.randn(6, n, d).astype(np.float32)
    ys = np.where(rng.rand(6, n) > 0.5, 1.0, -1.0).astype(np.float32)
    for kw in ({"mode": "dsgd"}, {"mode": "pushsum", "time_varying": True}):
        want_p, want_r = jdec.run_online_gossip(xs, ys, n, lr=0.2, **kw)
        got_p, got_r = decentralized.run_online_gossip(xs, ys, n, lr=0.2, device="cpu", **kw)
        np.testing.assert_allclose(got_p, want_p, atol=1e-6)
        np.testing.assert_allclose(got_r, want_r, atol=1e-6)
    with pytest.raises(ValueError, match="unknown gossip mode"):
        decentralized.run_online_gossip(xs, ys, n, mode="flood", device="cpu")
