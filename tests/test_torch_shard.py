"""The model axis: partition rules, the sharded FedSim round (FSDP and
tensor-parallel plans) over ``clients x model`` meshes of gloo ranks,
head-parallel flash attention, and packed lanes per client shard, against
the port on one rank and the JAX package (``tests/test_shard_parallel.py``'s
problems) from the same initial variables.

One launch of four gloo ranks (a ``2 x 2`` mesh) runs every multi-rank job
in a module fixture. Tolerances, fixed before the first run:

- rule matching: the port's spec of every variable equals JAX's spec of the
  same leaf through ``convert``'s name map, transposed as the leaf is (Dense
  kernels ``[in, out]`` -> weights ``[out, in]``, conv HWIO -> OIHW); error
  texts equal JAX's;
- an FSDP (``transformer_fsdp``) round: bitwise the port's one rank and the
  ``2 x 2`` mesh without rules (a client mesh of two, the model axis
  replicated), as every op sees the unsharded tensors;
- every plan against JAX's ``(2, 2)`` round: rtol 1e-5, atol 1e-6
  (``tests/test_shard_parallel.py:283-286``), on the variables and the
  metrics; the tensor-parallel rounds against the port's one rank at the
  same tolerance (their sums over the model axis reassociate);
- head-parallel attention: each rank's output bitwise the full-head
  version's on that rank's heads; where the heads do not divide the axis,
  JAX's warning and rtol/atol 1e-6 of ``attention_reference``
  (``tests/test_shard_parallel.py:397-417``);
- packed lanes per client shard: bitwise the port's one rank, 1e-5 of the
  JAX engine's packed round on a 2-device client mesh.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.data.synthetic import gaussian_blobs
from fedml_tpu.models.cnn import LeNet as JaxLeNet
from fedml_tpu.models.linear import LogisticRegression
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu.ops import attention as jattention
from fedml_tpu.parallel import dispatch as jdispatch
from fedml_tpu.parallel import rules as jrules
from fedml_tpu.parallel.mesh import MODEL_AXIS as J_MODEL
from fedml_tpu.parallel.mesh import client_mesh as jax_client_mesh
from fedml_tpu.parallel.multihost import flatten_variables as jax_flat
from fedml_tpu.sim.cohort import FederatedArrays as JaxArrays
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.core.trainer import ClientTrainer, adam, sgd
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.ops import attention
from fedml_tpu_torch.parallel import dispatch, launch, rehearsal, rules
from fedml_tpu_torch.parallel.mesh import MODEL_AXIS, client_mesh
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6


# ---------------------------------------------------------------------------
# the rules, leaf by leaf against JAX's
# ---------------------------------------------------------------------------


def _jax_specs_by_port_name(variables, specs, resnet=False):
    """JAX's spec of every leaf, under the port's name and in the port's
    layout: each leaf is tagged by its index, converted, and its spec
    permuted as ``convert`` permutes the leaf."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.arange(np.prod(np.shape(l)), dtype=np.float64).reshape(np.shape(l)) * 0 + i
                  for i, l in enumerate(leaves)])
    out = {}
    for name, t in convert.from_flax(tagged, resnet=resnet).items():
        i = int(t.reshape(-1)[0])
        rank = len(np.shape(leaves[i]))
        spec = tuple(spec_leaves[i]) + (None,) * (rank - len(spec_leaves[i]))
        if rank == 4:  # HWIO -> OIHW
            spec = (spec[3], spec[2], spec[0], spec[1])
        elif rank == 2 and name.endswith(".weight") and "embed" not in name:
            spec = spec[::-1]  # Dense [in, out] -> [out, in]
        out[name] = spec
    return out


def _padded(spec, rank):
    return tuple(spec) + (None,) * (rank - len(spec))


def _lm_pair(D=16, H=2, L=2, V=32, T=8):
    jm = JaxLM(vocab_size=V, embed_dim=D, num_layers=L, num_heads=H, max_len=T)
    variables = jax.tree.map(np.asarray, dict(jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((2, T), jnp.int32))))
    tm = TransformerLM(vocab_size=V, embed_dim=D, num_layers=L, num_heads=H, max_len=T,
                       device="cpu")
    return variables, tm.state_dict()


def _resnet_pair():
    jm = JaxResNet(depth=8, num_classes=10)
    variables = jax.tree.map(np.asarray, dict(jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)), train=False)))
    tm = CifarResNet(depth=8, num_classes=10, device="cpu")
    return variables, tm.state_dict()


@pytest.mark.parametrize("name,pair", [
    ("transformer_tp", "lm"), ("transformer_fsdp", "lm"), ("cnn_tp", "resnet"),
    ("cnn_fsdp", "resnet"), ("resnet_tp", "resnet"), ("resnet_fsdp", "resnet")])
def test_rule_sets_match_jax_leaf_by_leaf(name, pair):
    variables, state = _lm_pair() if pair == "lm" else _resnet_pair()
    jspecs = jrules.match_partition_rules(jrules.rule_set(name).rules, variables)
    want = _jax_specs_by_port_name(variables, jspecs, resnet=pair == "resnet")
    got = rules.match_partition_rules(rules.rule_set(name).rules, state)
    assert set(got) == set(want)
    for k, v in state.items():
        assert _padded(got[k], v.dim()) == _padded(want[k], v.dim()), k
    assert dispatch.plan_is_sharded(got) == jdispatch.plan_is_sharded(jspecs)
    assert rules.rule_set(name).gather_compute == jrules.rule_set(name).gather_compute
    assert rules.rule_set(name).act_spec == jrules.rule_set(name).act_spec


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_optimizer_state_matched_through_same_rules(opt):
    _, state = _lm_pair()
    ruleset = rules.rule_set("transformer_fsdp")
    params = {k: v for k, v in state.items()}
    optimizer = sgd(0.1, momentum=0.9) if opt == "sgd" else adam(1e-3)
    opt_specs = rules.match_partition_rules(ruleset.rules, optimizer.init(params))
    param_specs = rules.match_partition_rules(ruleset.rules, params)
    for k, spec in opt_specs.items():
        name = k.split("/", 1)[-1]
        assert spec == (rules.P() if k == "count" else param_specs[name]), k


def test_rule_errors_and_plans_are_jax():
    import jax as _jax

    def both(fn_j, fn_t):
        with pytest.raises(ValueError) as theirs:
            fn_j()
        with pytest.raises(ValueError) as ours:
            fn_t()
        assert str(ours.value) == str(theirs.value)

    shape = {"v": _jax.ShapeDtypeStruct((4,), np.float32)}
    both(lambda: jrules.match_partition_rules(((r"v$", JP(None, J_MODEL)),), shape),
         lambda: rules.match_partition_rules(((r"v$", rules.P(None, MODEL_AXIS)),),
                                             {"v": torch.zeros(4)}))
    mystery = {"w": _jax.ShapeDtypeStruct((4, 4), np.float32)}
    both(lambda: jrules.match_partition_rules(((r"qkv/kernel$", JP()),), mystery),
         lambda: rules.match_partition_rules(((r"qkv\.weight$", rules.P()),),
                                             {"w": torch.zeros(4, 4)}))
    both(lambda: jrules.rule_set("nope"), lambda: rules.rule_set("nope"))
    assert sorted(rules.RULE_SETS) == sorted(jrules.RULE_SETS)
    # scalars replicate without rules; the first matching rule wins
    specs = rules.match_partition_rules(
        ((r"w$", rules.P(MODEL_AXIS, None)), (r".*", rules.P())),
        {"a": torch.zeros(()), "b": torch.zeros(1), "w": torch.zeros(4, 8)})
    assert specs == {"a": rules.P(), "b": rules.P(), "w": rules.P(MODEL_AXIS, None)}
    for tree in ({"a": (), "b": (None, "model")}, {"a": (), "b": ("clients",)},
                 [(None, None), ("clients", "model")], ()):
        j = jax.tree.map(lambda s: JP(*s), tree, is_leaf=lambda x: isinstance(x, tuple))
        t = jax.tree.map(lambda s: rules.P(*s), tree, is_leaf=lambda x: isinstance(x, tuple))
        assert dispatch.plan_is_sharded(t) == jdispatch.plan_is_sharded(j), tree


# ---------------------------------------------------------------------------
# the problems (tests/test_shard_parallel.py's), the JAX rounds
# ---------------------------------------------------------------------------


def _lm_data(C=4, T=8, V=32, n_per=16):
    rng = np.random.RandomState(0)
    n = C * n_per
    x = rng.randint(0, V, (n, T)).astype(np.int32)
    y = rng.randint(0, V, (n, T)).astype(np.int32)
    mask = np.ones((n, T), np.float32)
    part = {i: np.arange(i * n_per, (i + 1) * n_per) for i in range(C)}
    return {"x": x, "y": y, "mask": mask}, part, {"x": x[:8], "y": y[:8], "mask": mask[:8]}


LM_CFG = dict(client_num_in_total=4, client_num_per_round=4, batch_size=4, comm_round=2,
              frequency_of_the_test=2, seed=0)
LM_CASES = {  # name -> (model kwargs, config, shard rules)
    "fsdp": ({}, dict(epochs=2, straggler_frac=0.5), "transformer_fsdp"),
    "tp": ({}, dict(epochs=1), "transformer_tp"),
    "packed_tp": ({}, dict(epochs=1, pack_lanes=2), "transformer_tp"),
    "tp_three_heads": ({"embed_dim": 12, "num_heads": 3}, dict(epochs=1), "transformer_tp"),
}


def _lm_kwargs(extra):
    return {"embed_dim": 16, "num_layers": 2, "num_heads": 2, "max_len": 8, **extra}


def _lenet_data(C=4, n_per=8):
    rng = np.random.RandomState(0)
    n = C * n_per
    x = rng.rand(n, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)
    return {"x": x, "y": y}, {i: np.arange(i * n_per, (i + 1) * n_per) for i in range(C)}


CNN_CFG = dict(client_num_in_total=4, client_num_per_round=4, batch_size=4, comm_round=2,
               epochs=1, frequency_of_the_test=2, seed=0)
BLOBS = dict(client_num_in_total=8, client_num_per_round=4, batch_size=8, comm_round=3,
             epochs=2, frequency_of_the_test=3, seed=0, pack_lanes=2)


def _jax_run(trainer, train, test, cfg, mesh_shape=None, shard_rules=None, n_devices=None,
             init=None):
    mesh = None if mesh_shape else jax_client_mesh(jax.devices()[:n_devices])
    sim = JaxSim(trainer, train, test, dataclasses.replace(
        cfg, mesh_shape=mesh_shape, shard_rules=shard_rules), mesh=mesh)
    init = init if init is not None else jax.tree.map(np.asarray, sim.init_variables())
    variables, history = sim.run(variables=init)
    return init, jax_flat(variables), history, sim.shard_summary()


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's (2, 2) rounds of each plan and its packed round on a 2-device
    client mesh, with their initial variables."""
    out = {}
    arrays, part, test = _lm_data()
    for name, (extra, cfg, shard) in LM_CASES.items():
        kw = _lm_kwargs(extra)
        trainer = JaxTrainer(module=JaxLM(vocab_size=32, **kw), task="nwp",
                             optimizer=optax.sgd(0.1, momentum=0.9), epochs=cfg["epochs"])
        out[name] = _jax_run(trainer, JaxArrays(arrays, part), test,
                             JaxConfig(**LM_CFG, **cfg), (2, 2), shard)
    x, part = _lenet_data()
    for shard in ("cnn_fsdp", "cnn_tp"):
        trainer = JaxTrainer(module=JaxLeNet(num_classes=10), optimizer=optax.sgd(0.1),
                             epochs=1)
        out[shard] = _jax_run(trainer, JaxArrays(x, part), None, JaxConfig(**CNN_CFG),
                              (2, 2), shard)
    train, test = gaussian_blobs(n_clients=8, samples_per_client=24, num_classes=4, seed=11)
    trainer = JaxTrainer(module=LogisticRegression(num_classes=4), optimizer=optax.sgd(0.2),
                         epochs=2)
    out["packed"] = _jax_run(trainer, train, test, JaxConfig(**BLOBS), n_devices=2)
    return out


def _specs(jax_runs):
    """The port's rank programs, each from JAX's initial variables."""
    specs = {}
    arrays, part, test = _lm_data()
    for name, (extra, cfg, _) in LM_CASES.items():
        init = convert.from_flax(jax_runs[name][0])
        specs[name] = dict(data=(arrays, part, test),
                           model=("transformer", 32, _lm_kwargs(extra)),
                           trainer=dict(task="nwp", optimizer=("sgd", 0.1, 0.9),
                                        epochs=cfg["epochs"]),
                           config={**LM_CFG, **cfg},
                           init={k: v.numpy() for k, v in init.items()})
    x, part = _lenet_data()
    for shard in ("cnn_fsdp", "cnn_tp"):
        init = convert.from_flax(jax_runs[shard][0])
        specs[shard] = dict(data=(x, part, None), model=("lenet", 10, {}),
                            trainer=dict(optimizer=("sgd", 0.1), epochs=1), config=dict(CNN_CFG),
                            init={k: v.numpy() for k, v in init.items()})
    train, test = gaussian_blobs(n_clients=8, samples_per_client=24, num_classes=4, seed=11)
    init = convert.from_flax(jax_runs["packed"][0])
    specs["packed"] = dict(data=(train.arrays, train.partition, test),
                           model=("lr", 4, {"input_shape": (16,)}),
                           trainer=dict(optimizer=("sgd", 0.2), epochs=2), config=dict(BLOBS),
                           init={k: v.numpy() for k, v in init.items()})
    return specs


def _with(spec, **config):
    return {**spec, "config": {**spec["config"], **config}}


def _qkv(heads, seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.rand(2, heads, 8, 4).astype(np.float32) for k in ("q", "k", "v")}


JOBS = ["fsdp", "fsdp_unsharded", "tp", "packed_tp", "tp_three_heads", "cnn_fsdp", "cnn_tp",
        "packed", "head_parallel", "head_parallel_three", "roundtrip"]


@pytest.fixture(scope="module")
def specs(jax_runs):
    return _specs(jax_runs)


@pytest.fixture(scope="module")
def four_ranks(specs):
    """Every multi-rank job on a 2 x 2 mesh of four gloo ranks, one launch."""
    _, state = _lm_pair()
    jobs = [("run_sim", _with(specs["fsdp"], mesh_shape=(2, 2), shard_rules="transformer_fsdp")),
            ("run_sim", _with(specs["fsdp"], mesh_shape=(2, 2))),
            ("run_sim", _with(specs["tp"], mesh_shape=(2, 2), shard_rules="transformer_tp")),
            ("run_sim", _with(specs["packed_tp"], mesh_shape=(2, 2),
                              shard_rules="transformer_tp")),
            ("run_sim", _with(specs["tp_three_heads"], mesh_shape=(2, 2),
                              shard_rules="transformer_tp")),
            ("run_sim", _with(specs["cnn_fsdp"], mesh_shape=(2, 2), shard_rules="cnn_fsdp")),
            ("run_sim", _with(specs["cnn_tp"], mesh_shape=(2, 2), shard_rules="cnn_tp")),
            ("run_sim", _with(specs["packed"], mesh_shape=(2, 2))),
            ("head_parallel", dict(_qkv(2), mesh_shape=(2, 2), causal=True)),
            ("head_parallel", dict(_qkv(3), mesh_shape=(2, 2), causal=True)),
            ("shard_roundtrip", dict(state={k: v.numpy() for k, v in state.items()},
                                     rules="transformer_tp", mesh_shape=(2, 2)))]
    assert len(jobs) == len(JOBS)
    return launch.launch(rehearsal.run_jobs, 4, jobs, backend="gloo", platform="cpu",
                         timeout_s=600.0)


@pytest.fixture(scope="module")
def one_rank(specs):
    """The FedSim problems on one rank, in this process: the unsharded
    rounds the plans are held to."""
    return {name: rehearsal.run_sim(CPU, spec) for name, spec in specs.items()}


def _job(four_ranks, name):
    return [r[JOBS.index(name)] for r in four_ranks]


def _close(port, want, rtol=RTOL, atol=ATOL):
    flat, history = want
    np.testing.assert_allclose(port["flat"], flat, rtol=rtol, atol=atol)
    assert len(port["history"]) == len(history)
    for rp, rj in zip(port["history"], history):
        for k in rp:
            np.testing.assert_allclose(rp[k], rj[k], rtol=rtol, atol=atol, err_msg=k)


def test_fsdp_round_is_bitwise_unsharded_and_matches_jax(four_ranks, one_rank, jax_runs):
    ranks, plain = _job(four_ranks, "fsdp"), _job(four_ranks, "fsdp_unsharded")
    for r in ranks + plain:
        assert r["mesh"] == {"clients": 2, "model": 2}
        np.testing.assert_array_equal(r["flat"], one_rank["fsdp"]["flat"])
        assert r["history"] == one_rank["fsdp"]["history"]
    # the model blocks gathered once a round for compute, once for the eval
    assert ranks[0]["traffic"]["all_gather"]["calls"] > plain[0]["traffic"]["all_gather"]["calls"]
    _close(ranks[0], jax_runs["fsdp"][1:3])


@pytest.mark.parametrize("name", ["tp", "packed_tp", "cnn_fsdp", "cnn_tp"])
def test_plans_match_jax_and_one_rank(four_ranks, one_rank, jax_runs, name):
    ranks = _job(four_ranks, name)
    for r in ranks:
        assert r["mesh"] == {"clients": 2, "model": 2}
        np.testing.assert_array_equal(r["flat"], ranks[0]["flat"])
        _close(r, (one_rank[name]["flat"], one_rank[name]["history"]))
    _close(ranks[0], jax_runs[name][1:3])
    if name.endswith("tp") and "cnn" not in name:
        # the model's own collectives over the model axis ran
        assert ranks[0]["traffic"]["all_reduce"]["calls"] > 0


def test_three_heads_under_tp_warn_and_match(four_ranks, one_rank, jax_runs):
    """3 heads on a 2-way model axis: JAX's warning, no kernel launch (the
    plain version on the CPU counts none either), the round within the
    tolerance of one rank and of JAX's."""
    ranks = _job(four_ranks, "tp_three_heads")
    for r in ranks:
        _close(r, (one_rank["tp_three_heads"]["flat"], one_rank["tp_three_heads"]["history"]))
        assert r["flash"] == (0, 0)
    _close(ranks[0], jax_runs["tp_three_heads"][1:3])


def test_head_parallel_attention_per_rank_is_the_full_heads(four_ranks):
    spec = _qkv(2)
    full = attention.flash_attention(*(torch.as_tensor(spec[k]) for k in "qkv"), True)
    full = full.transpose(1, 2).reshape(2, 8, 8).numpy()  # [B, T, H * D]
    for r in _job(four_ranks, "head_parallel"):
        assert r["ranks"] == 2 and not r["warnings"]
        c = slice(r["rank"] * 4, (r["rank"] + 1) * 4)
        np.testing.assert_array_equal(r["out"], full[..., c])
    # the JAX function per rank: the same numbers
    want = np.asarray(jattention.flash_attention(*(jnp.asarray(spec[k]) for k in "qkv"), True))
    np.testing.assert_allclose(full, want.transpose(0, 2, 1, 3).reshape(2, 8, 8), atol=1e-6)


def test_head_parallel_divisibility_fallback_warns(four_ranks, caplog):
    spec = _qkv(3)
    ref = attention.attention_reference(*(torch.as_tensor(spec[k]) for k in "qkv"), causal=True)
    ref = ref.transpose(1, 2).reshape(2, 8, 12).numpy()
    # JAX's warning, from its own function on a 2-device model mesh
    from jax.sharding import Mesh

    with Mesh(np.asarray(jax.devices()[:2]), (J_MODEL,)), caplog.at_level(
            logging.WARNING, logger="fedml_tpu.ops.attention"):
        jattention.flash_attention_head_parallel(
            *(jnp.asarray(spec[k]) for k in "qkv"), axis=J_MODEL, causal=True)
    jax_msg = [r.getMessage() for r in caplog.records][-1]
    for r in _job(four_ranks, "head_parallel_three"):
        assert r["warnings"] == [jax_msg]
        assert "2-way 'model' model axis: 3 heads do not divide" in jax_msg
        assert r["flash"] == (0, 0)
        c = slice(r["rank"] * 6, (r["rank"] + 1) * 6)
        np.testing.assert_allclose(r["out"], ref[..., c], rtol=1e-6, atol=1e-6)


def test_qkv_blocks_are_whole_heads_and_unshard_exactly(four_ranks):
    _, state = _lm_pair()
    for r in _job(four_ranks, "roundtrip"):
        for k, v in state.items():
            np.testing.assert_array_equal(r["full"][k], v.numpy(), err_msg=k)
        qkv = state["blocks.0.attn.qkv.weight"].numpy()  # [q|k|v] rows, 16 each
        rows = np.concatenate([qkv[g * 16 + r["coord"] * 8:g * 16 + (r["coord"] + 1) * 8]
                               for g in range(3)])
        np.testing.assert_array_equal(r["blocks"]["blocks.0.attn.qkv.weight"], rows)
        assert r["blocks"]["head.weight"].shape == (16, 16)


def test_packed_lanes_per_client_shard(four_ranks, one_rank, jax_runs):
    for r in _job(four_ranks, "packed"):
        np.testing.assert_array_equal(r["flat"], one_rank["packed"]["flat"])
        assert r["history"] == one_rank["packed"]["history"]
    _close(_job(four_ranks, "packed")[0], jax_runs["packed"][1:3])


def test_shard_summary_and_guards(jax_runs, caplog):
    """JAX's keys and counts; the default 1 x world model mesh (one rank
    here); JAX's guards and warnings, in-process."""
    arrays, part, test = _lm_data()
    train = FederatedArrays(arrays, part)

    def sim(cfg=None, model=None, **kw):
        trainer = ClientTrainer(module=model or create_model(
            "transformer", 32, device="cpu", **_lm_kwargs({})), task="nwp",
            optimizer=sgd(0.1, 0.9))
        return FedSim(trainer, train, test, SimConfig(**{**LM_CFG, "epochs": 1, **(cfg or {})}),
                      device="cpu", **kw)

    s = sim({"shard_rules": "transformer_tp"})
    want = jax_runs["tp"][3]
    got = s.shard_summary()
    assert set(got) == set(want)
    assert got["mesh"] == {"clients": 1, "model": 1}
    assert {k: got[k] for k in got if k != "mesh"} == {k: want[k] for k in want if k != "mesh"}
    assert s.trainer.module.mp_axis == MODEL_AXIS
    assert sim().shard_summary() == {}
    with pytest.raises(ValueError, match="block_dispatch"):
        sim({"shard_rules": "transformer_fsdp", "block_dispatch": True})
    with pytest.raises(ValueError, match="mesh"):
        sim({"mesh_shape": (1, 1)}, mesh=client_mesh())
    with pytest.raises(ValueError, match="model"):
        sim({"shard_rules": "transformer_fsdp"}, mesh=client_mesh())
    from fedml_tpu_torch.algorithms.decentralized import gossip_aggregator
    from fedml_tpu_torch.topology.topology import ring_topology

    with pytest.raises(ValueError, match="per-client"):
        sim({"shard_rules": "transformer_fsdp"}, aggregator=gossip_aggregator(ring_topology(4)))
    lr = create_model("lr", 4, device="cpu", input_shape=(8,))
    with caplog.at_level(logging.WARNING):
        s = sim({"shard_rules": "transformer_fsdp"}, model=lr)
    assert "matched no shardable leaf" in caplog.text and not s._spmd
    assert s.shard_summary()["mode"] == "shard_map"
