"""Compressed FedSim rounds in the port (``SimConfig.compressor``, the
engine's wiring of ``compress/aggregate.py``) against the JAX engine's, on
the same numpy-made inputs from the same converted initial variables.

Tolerances:

- LogisticRegression on gaussian blobs, 8 of 8 clients, top-k 0.05 with
  error feedback, 3 rounds in vmap, scan and blocks (on the CPU a block
  runs its rounds eagerly): the model, the round loss and the ``Comm/*``
  metrics atol 1e-5 each round against the JAX engine (8 clients fill its
  8-device CPU mesh, so it pads no slot), and each client's top-k support
  equal to JAX's each round (a near-tie that swaps the k-th and (k+1)-th
  entries fails as a swap, never as a tolerance). Blocks agree with vmap
  bitwise (a block on the CPU runs the vmap mode's rounds in turn);
- q8 without error feedback at 4 of 8 clients: every client's decoded
  update within ``scale / levels`` of its input, leaf by leaf, each round;
  the uplink bytes 4 x one client's encoded bytes;
- packed lanes (3 lanes over the hetero clients) against the padded round
  with top-k and q4: bitwise on the CPU;
- ``StaticNoise`` filled from a round's ``RoundNoise``: each draw, of
  either kind, bitwise the eager draw;
- the JAX engine's refusals: the same exception types and messages;
- the CLI's flags: the same table as the JAX CLI's; ``--compressor``
  runs reach the engine;
- a compressed run stopped after round 2 and resumed from its checkpoint
  (the residual stack in the server state) to round 4: bitwise the
  uninterrupted run's history and model.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import collections
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.compress import codec as jcodec
from fedml_tpu.core import rng as jrng
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.exp import main_fedavg as jax_cli
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.compress import aggregate as aggregatelib
from fedml_tpu_torch.compress import codec
from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.data.synthetic import gaussian_blobs
from fedml_tpu_torch.exp import main_fedavg as port_cli
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.obs import metrics as metricslib
from fedml_tpu_torch.sim.engine import FedSim, SimConfig

ATOL = 1e-5
COMM = (metricslib.COMM_UPLINK_BYTES, metricslib.COMM_UPLINK_DENSE_BYTES,
        metricslib.COMM_DOWNLINK_BYTES, metricslib.COMM_DOWNLINK_DENSE_BYTES,
        metricslib.COMM_RATIO)


def _blobs(n_clients=8):
    return gaussian_blobs(n_clients=n_clients, samples_per_client=24, num_classes=4, dim=16,
                          partition_method="hetero", partition_alpha=0.5, seed=2)


def _cfg(**kw):
    base = dict(client_num_in_total=8, client_num_per_round=8, batch_size=8, comm_round=3,
                epochs=1, frequency_of_the_test=3, eval_batch_size=16, seed=3,
                compressor="topk", topk_frac=0.05)
    base.update(kw)
    return base


def _port_sim(train, test, **kw):
    module = create_model("lr", 4, "synthetic", device="cpu", input_shape=(16,))
    return FedSim(ClientTrainer(module=module, optimizer=sgd(0.3)), train, test,
                  SimConfig(**kw), device="cpu")


def _jax_sim(train, test, **kw):
    return JaxSim(JaxTrainer(module=JaxLR(num_classes=4), optimizer=optax.sgd(0.3)),
                  jcohort.FederatedArrays(train.arrays, train.partition), test, JaxConfig(**kw))


# the LogisticRegression's leaves in flax's tree
FLAX_PATH = {"dense_0.weight": "params/Dense_0/kernel", "dense_0.bias": "params/Dense_0/bias"}


def _flax_positions(port_sd):
    """For each leaf name of a port state dict, the flax-layout flat position
    of each port-layout flat index (a Linear weight is the kernel
    transposed)."""
    ids = {k: torch.arange(v.numel(), dtype=torch.float64).reshape(v.shape)
           for k, v in port_sd.items()}
    flax = convert.to_flax(ids)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(flax)[0]:
        name = "/".join(str(p.key) for p in path)
        pos = np.empty(leaf.size, np.int64)
        pos[np.asarray(leaf).reshape(-1).astype(np.int64)] = np.arange(leaf.size)
        out[name] = pos
    return out


@pytest.fixture
def supports(monkeypatch):
    """Each client's top-k support, as a sorted per-leaf tuple in flax's
    layout, recorded per round from both packages' codecs."""
    rec = {"jax": [], "port": []}
    j_encode, t_encode = jcodec.TopKCodec.encode, codec.TopKCodec.encode

    def j_recording(self, tree, rng):
        enc = j_encode(self, tree, rng)

        def keep(idx):
            rec["jax"].append(tuple(
                ("/".join(str(p.key) for p in path), tuple(sorted(np.asarray(v).tolist())))
                for path, v in jax.tree_util.tree_flatten_with_path(idx)[0]))

        jax.debug.callback(keep, enc.planes["indices"])
        return enc

    def t_recording(self, tree, rng):
        enc = t_encode(self, tree, rng)
        pos = _flax_positions(tree)
        rec["port"].append(tuple(sorted(
            (FLAX_PATH[k], tuple(sorted(pos[FLAX_PATH[k]][idx.long().numpy()].tolist())))
            for k, idx in enc.planes["indices"].items())))
        return enc

    monkeypatch.setattr(jcodec.TopKCodec, "encode", j_recording)
    monkeypatch.setattr(codec.TopKCodec, "encode", t_recording)
    return rec


def _supports(records, n_clients):
    """The multiset of a round's client supports. The JAX engine runs the
    aggregation on each device of its mesh, so each of its clients is
    recorded once a device: the counts are divided by that multiplicity."""
    assert len(records) % n_clients == 0
    copies = len(records) // n_clients
    counts = collections.Counter(tuple(sorted(r)) for r in records)
    assert all(v % copies == 0 for v in counts.values())
    return {k: v // copies for k, v in counts.items()}


def _close(j_vars, t_vars, atol=ATOL):
    back = convert.to_flax(t_vars)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(j_vars))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=atol, err_msg=str(path))


def test_topk_ef_rounds_match_jax_on_every_path(supports):
    train, test = _blobs()
    kw = _cfg()
    jsim = _jax_sim(train, test, **kw)
    j_vars = jsim.init_round_variables()
    j_state = jsim.aggregator.init_state(j_vars)
    init = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    root = jrng.root_key(kw["seed"])
    j_hist, j_sup = [], []
    for r in range(kw["comm_round"]):
        j_vars, j_state, j_m = jsim.run_round(r, j_vars, j_state, root)
        jax.effects_barrier()
        j_hist.append((jax.tree.map(np.asarray, dict(j_vars)),
                       {k: float(v) for k, v in j_m.items()}))
        j_sup.append(_supports(supports["jax"], 8))
        supports["jax"].clear()
    runs = {}
    for mode, extra in (("vmap", {}), ("scan", {"cohort_execution": "scan"}),
                        ("blocks", {"block_dispatch": True})):
        supports["port"].clear()
        sim = _port_sim(train, test, **{**kw, **extra})
        t_vars = {k: v.clone() for k, v in init.items()}
        state = sim.aggregator.init_state(t_vars)
        per_round = []
        if mode == "blocks":
            t_vars, state, stacked = sim.run_block(0, kw["comm_round"], t_vars, state)
            per_round = [(None, {k: float(v[r]) for k, v in stacked.items()})
                         for r in range(kw["comm_round"])]
            per_round[-1] = (t_vars, per_round[-1][1])
        else:
            for r in range(kw["comm_round"]):
                t_vars, state, t_m = sim.run_round(r, t_vars, state)
                per_round.append(({k: v.clone() for k, v in t_vars.items()},
                                  {k: float(v) for k, v in t_m.items()}))
        assert len(supports["port"]) == 8 * kw["comm_round"]
        for r, ((want_vars, want_m), (got_vars, got_m)) in enumerate(zip(j_hist, per_round)):
            got_sup = _supports(supports["port"][8 * r:8 * (r + 1)], 8)
            assert got_sup == j_sup[r], f"{mode} round {r}: a top-k support differs"
            if got_vars is not None:
                _close(want_vars, got_vars)
            assert set(got_m) == set(want_m) >= set(COMM)
            for k in want_m:
                np.testing.assert_allclose(got_m[k], want_m[k], atol=ATOL, err_msg=f"{mode} {k}")
        runs[mode] = (t_vars, state)
    # a block on the CPU is the vmap mode's rounds one after another
    for k, v in runs["vmap"][0].items():
        assert torch.equal(runs["blocks"][0][k], v), k
    for k, v in runs["vmap"][1]["residual"].items():
        assert torch.equal(runs["blocks"][1]["residual"][k], v), k
    assert any(bool(torch.any(v != 0)) for v in runs["vmap"][1]["residual"].values())


def test_q8_without_feedback_at_partial_participation_stays_in_its_bound(monkeypatch):
    train, test = _blobs()
    checked = []
    original = aggregatelib.ef.encode_with_feedback

    def bounded(codec_, comp, rng):
        enc, dec, res = original(codec_, comp, rng)
        for k, x in comp.items():
            scale = float(enc.planes["scale"][k])
            assert float(torch.max(torch.abs(dec[k] - x))) <= scale / 127 * (1 + 1e-6), k
        checked.append(enc.nbytes)
        return enc, dec, res

    monkeypatch.setattr(aggregatelib.ef, "encode_with_feedback", bounded)
    sim = _port_sim(train, test, **_cfg(client_num_per_round=4, compressor="q8",
                                        error_feedback=False, pipeline_depth=0))
    assert sim.aggregator.name == "compressed[q8]>fedavg"
    assert sim.aggregator.init_state(sim.init_variables())["residual"] == ()
    _, hist = sim.run()
    assert len(checked) == 3 * 4
    for rec in hist:
        assert np.isfinite(rec["Train/Loss"])
        assert rec[metricslib.COMM_UPLINK_BYTES] == 4 * checked[0]
        assert rec[metricslib.COMM_RATIO] == pytest.approx(
            rec[metricslib.COMM_UPLINK_DENSE_BYTES] / rec[metricslib.COMM_UPLINK_BYTES], rel=1e-6)


@pytest.mark.parametrize("spec", ["topk", "q4"])
def test_packed_compressed_rounds_equal_padded_bitwise(spec):
    """Packed lanes feed the wrapper the padded round's stack
    (``_packed_aggregate``): the same codec inputs, the same uniforms."""
    train, test = _blobs()
    hists = []
    for pack in (0, 3):
        sim = _port_sim(train, test, **_cfg(compressor=spec, pack_lanes=pack, pipeline_depth=0))
        variables, hist = sim.run()
        hists.append(([{k: v for k, v in r.items() if k != "round_time"} for r in hist],
                      variables))
    (h0, v0), (h1, v1) = hists
    assert h0 == h1 and metricslib.COMM_RATIO in h0[0]
    assert all(torch.equal(v0[k], v1[k]) for k in v0)


def test_static_noise_redraws_each_kind_as_the_round_noise_serves_it():
    """A captured round's draws (``sim/graphs.py`` ``StaticNoise``): the
    buffers made at the warm-up remember whether they hold gaussians or
    uniforms, and a fill from a round's ``RoundNoise`` serves, call by
    call, bitwise what that ``RoundNoise`` serves eagerly (one counter for
    both kinds, a tag each)."""
    from fedml_tpu_torch.core.rng import RoundNoise
    from fedml_tpu_torch.sim.graphs import StaticNoise

    calls = [("uniform", (5, 3)), ("normal", (4,)), ("uniform", (7,))]
    static = StaticNoise(torch.device("cpu"))
    for kind, shape in calls:  # the warm-up makes the buffers
        getattr(static, kind)(shape)
    for round_idx in (3, 4):
        static.fill(RoundNoise(9, round_idx))
        static.rewind()
        eager = RoundNoise(9, round_idx)
        for kind, shape in calls:
            assert torch.equal(getattr(static, kind)(shape), getattr(eager, kind)(shape))
    u = RoundNoise(9, 3).uniform((10_000,))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert not torch.equal(u, RoundNoise(9, 4).uniform((10_000,)))
    static.rewind()
    with pytest.raises(RuntimeError, match="draw 0 is normal"):
        static.normal((5, 3))


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return type(e), str(e)
    return None


REFUSALS = {
    "ef_partial": dict(client_num_per_round=4),
    "ef_population": dict(population="speed=const:1;avail=0.9"),
    "downlink": dict(compressor="none", downlink_compressor="topk"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    train, test = _blobs()
    kw = _cfg(**REFUSALS[case])
    want = _error(lambda: _jax_sim(train, test, **kw))
    got = _error(lambda: _port_sim(train, test, **kw))
    assert want is not None and got == want


def _table(parser, dests):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None)
            for a in parser._actions if a.dest in dests}


def test_cli_flags_reach_the_engine(tmp_path, monkeypatch):
    dests = {"compressor", "topk_frac", "quantize_bits", "error_feedback"}
    ours = _table(port_cli.add_args(argparse.ArgumentParser()), dests)
    assert ours == _table(jax_cli.add_args(argparse.ArgumentParser()), dests)
    assert len(ours) == 4
    built = []
    monkeypatch.setattr(FedSim, "_compressed", _recording(FedSim._compressed, built))
    argv = ["--dataset", "synthetic_0.5_0.5", "--client_num_in_total", "6",
            "--client_num_per_round", "3", "--comm_round", "2", "--frequency_of_the_test",
            "2", "--data_dir", str(tmp_path), "--device", "cpu"]
    final = port_cli.main(argv + ["--compressor", "q4", "--error_feedback", "0"])
    assert built[-1][1:] == ("q4", False, 8)
    assert final[metricslib.COMM_RATIO] > 7.0  # 4 bits and a scale a leaf
    final = port_cli.main(argv + ["--compressor", "topk+q8", "--topk_frac", "0.25",
                                  "--quantize_bits", "4", "--error_feedback", "0"])
    assert built[-1] == (0.25, "topk+q8", False, 4)
    with pytest.raises(ValueError, match="error feedback keys residuals"):
        port_cli.main(argv + ["--compressor", "topk"])


def _recording(original, built):
    def compressed(self, config, inner):
        built.append((config.topk_frac, config.compressor, config.error_feedback,
                      config.quantize_bits))
        return original(self, config, inner)
    return compressed


def test_compressed_resume_is_bitwise(tmp_path):
    train_dir = tmp_path / "none"
    argv = ["--dataset", "synthetic_0.5_0.5", "--client_num_in_total", "6",
            "--client_num_per_round", "6", "--frequency_of_the_test", "2", "--data_dir",
            str(train_dir), "--device", "cpu", "--compressor", "topk", "--topk_frac", "0.1"]

    def run(rounds, ckpt, *extra):
        args = port_cli.parse_with_config(port_cli.add_args(argparse.ArgumentParser()), argv + [
            "--comm_round", str(rounds), "--checkpoint_dir", str(tmp_path / ckpt),
            "--checkpoint_every", "1", "--save_params_to", str(tmp_path / f"{ckpt}{rounds}"),
            *extra])
        return port_cli.run(args)

    straight = run(4, "a")
    run(2, "b")
    resumed = run(4, "b", "--resume", "1")
    assert resumed == straight
    a, b = np.load(tmp_path / "a4.npz"), np.load(tmp_path / "b4.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    from fedml_tpu_torch.obs.checkpoint import RoundCheckpointer

    like = {"dense_0.weight": torch.zeros(10, 60), "dense_0.bias": torch.zeros(10)}
    _, state, _, _ = RoundCheckpointer(tmp_path / "b").restore(
        like, like_server_state={"inner": (), "residual": {k: torch.zeros((6,) + v.shape)
                                                          for k, v in like.items()}})
    assert any(bool(torch.any(v != 0)) for v in state["residual"].values())


def test_simconfig_keeps_only_the_unported_fields():
    from fedml_tpu_torch.sim import engine

    assert sorted(engine._NOT_PORTED) == ["downlink_compressor", "mesh_shape", "shard_rules"]
    SimConfig(compressor="topk+q4", topk_frac=0.1, quantize_bits=4, error_feedback=False)
    assert dataclasses.replace(SimConfig(), downlink_compressor="none")
