"""The port's update compression (``fedml_tpu_torch/compress``) against the
JAX package's (``fedml_tpu/compress``), on the same numpy-made arrays.

Tolerances:

- every codec spec (none, bf16, topk, q8, q4, quantize, topk+q4, topk+q8,
  bf16+topk) on the same flat arrays in the same leaf order: the planes and
  ``nbytes`` equal, the decoded update within one f32 ulp (rtol 2.4e-7) of
  the jitted JAX decode (XLA computes the quantizers' ``q / levels *
  scale`` in an order that depends on the leaf's shape, e.g. ``q * (scale
  / levels)``; op by op JAX computes the port's order; the top-k and bf16
  decodes agree bitwise); The quantizers are fed the
  uniforms JAX draws from its key (a stub that serves them through
  ``.uniform``), so their stochastic rounding meets the same numbers;
- top-k on an exact tie keeps the lower index, as ``jax.lax.top_k`` does;
- ``make_codec``'s errors: the JAX package's exception types and messages;
- q8 and q4: every decoded entry within ``scale / levels`` of its input,
  and the mean of 400 decodes within 4 standard errors (of stochastic
  rounding, ``sqrt(p (1 - p) / 400) * scale / levels``) + 1e-6 of the input
  (unbiasedness), with the port's own ``RoundNoise`` uniforms;
- three steps of error feedback with top-k: the residuals bitwise JAX's;
- ``compressed_aggregator`` over FedAvg, FedAdam and the median, three
  chained rounds with error feedback (top-k), and once with q8 fed JAX's
  uniforms: the aggregate and the residuals atol 1e-6 (f32 means taken in
  other orders; the FedAdam case runs the JAX rule op by op, as XLA's
  fusions round its pseudo-gradient otherwise and Adam's ``m / (sqrt(v) +
  eps)`` grows such a rounding past 1e-6), the ``Comm/*`` metrics equal to
  rel 1e-6;
- error feedback over a BatchNorm running variance (top-k keeps one entry
  of 100): the two packages agree at atol 1e-6 and both drive the
  variance below zero in round 2 (ROADMAP §C);
- ``make_local_update`` with top-k + EF on a LogisticRegression, two
  updates: the decoded payload and the residual atol 1e-6 after
  ``convert.to_flax`` with equal top-k supports, the byte metrics equal.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms.base import fedavg_aggregator as jax_fedavg
from fedml_tpu.algorithms.fedopt import fedopt_aggregator as jax_fedopt
from fedml_tpu.algorithms.fedopt import server_optimizer as jax_server_optimizer
from fedml_tpu.algorithms.robust import RobustConfig as JaxRobustConfig
from fedml_tpu.algorithms.robust import robust_aggregator as jax_robust
from fedml_tpu.compress import codec as jcodec
from fedml_tpu.compress import error_feedback as jef
from fedml_tpu.compress.aggregate import compressed_aggregator as jax_compressed
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.core.trainer import make_local_update as jax_local_update
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms.base import fedavg_aggregator
from fedml_tpu_torch.algorithms.decentralized import gossip_aggregator
from fedml_tpu_torch.algorithms.fedopt import fedopt_aggregator, server_optimizer
from fedml_tpu_torch.algorithms.robust import RobustConfig, robust_aggregator
from fedml_tpu_torch.compress import codec
from fedml_tpu_torch.compress import error_feedback as ef
from fedml_tpu_torch.compress.aggregate import compressed_aggregator
from fedml_tpu_torch.core.rng import RoundNoise
from fedml_tpu_torch.core.trainer import ClientTrainer, make_local_update, sgd
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.obs import metrics as metricslib

SPECS = ["none", "bf16", "topk", "q8", "q4", "quantize", "topk+q4", "topk+q8", "bf16+topk"]
# leaf names that JAX's sorted traversal visits in the dict's order; odd
# sizes exercise q4's padding nibble
SHAPES = {"a": (64, 32), "b": (33,), "c": (5, 3, 3), "d": (1,)}


class JaxUniforms:
    """Serves, through ``.uniform(shape)``, the uniforms a JAX codec draws
    from ``key``, in the order the port's codec asks for them."""

    def __init__(self, arrays):
        self._it = iter(arrays)

    def uniform(self, shape, dtype=torch.float32):
        u = torch.from_numpy(np.array(next(self._it)))
        assert tuple(u.shape) == tuple(shape) and u.dtype == dtype
        return u


def _quantizer_uniforms(key, sizes):
    keys = jax.random.split(key, max(len(sizes), 1))
    return [jax.random.uniform(k, (n,)) for k, n in zip(keys, sizes)]


def jax_draws(spec, key, tree, topk_frac=0.01):
    """The uniforms JAX's ``make_codec(spec)`` draws from ``key`` encoding
    ``tree`` (a flat dict of arrays), stage by stage, leaf by leaf."""
    parts = spec.split("+")
    sizes = [int(np.prod(v.shape)) for v in tree.values()]

    @jax.jit
    def draws(key):
        keys = [key] if len(parts) == 1 else list(jax.random.split(key, len(parts)))
        n, out = sizes, []
        for part, k in zip(parts, keys):
            if part in ("q4", "q8", "quantize"):
                out += _quantizer_uniforms(k, n)
            elif part == "topk":
                n = [max(1, int(np.ceil(topk_frac * m))) for m in n]
        return out

    return draws(key)


def _tree(rng, shapes=SHAPES):
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def _np(x):
    """A plane leaf as comparable numpy (bf16 as its bits)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy())
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _assert_planes_equal(jenc, tenc):
    assert jenc.scheme == tenc.scheme
    assert sorted(jenc.planes) == sorted(tenc.planes)
    assert jenc.meta_dict() == tenc.meta_dict()
    for name, jplane in jenc.planes.items():
        tplane = tenc.planes[name]
        if isinstance(jplane, jcodec.EncodedUpdate):
            _assert_planes_equal(jplane, tplane)
            continue
        assert list(jplane) == list(tplane)
        for k in jplane:
            want, got = _np(jplane[k]), _np(tplane[k])
            assert want.dtype == got.dtype and want.shape == got.shape, (name, k)
            np.testing.assert_array_equal(got, want, err_msg=f"{name}/{k}")


@pytest.mark.parametrize("spec", SPECS)
def test_codec_planes_match_jax_bitwise(rng, spec):
    tree = _tree(rng)
    key = jax.random.key(3)
    jc, tc = jcodec.make_codec(spec, topk_frac=0.05), codec.make_codec(spec, topk_frac=0.05)
    jenc = jax.jit(jc.encode)({k: jnp.asarray(v) for k, v in tree.items()}, key)
    tenc = tc.encode({k: torch.from_numpy(v) for k, v in tree.items()},
                     JaxUniforms(jax_draws(spec, key, tree, topk_frac=0.05)))
    _assert_planes_equal(jenc, tenc)
    assert tenc.nbytes == jenc.nbytes
    jdec, tdec = jax.jit(jc.decode)(jenc), tc.decode(tenc)
    for k in tree:
        assert tdec[k].dtype == torch.float32 and tuple(tdec[k].shape) == tree[k].shape
        # one f32 ulp: XLA's fusion of ``q / levels * scale`` (its order
        # depends on the leaf's shape; op by op, JAX's is the port's)
        np.testing.assert_allclose(tdec[k].numpy(), np.asarray(jdec[k]), rtol=2.4e-7, atol=0,
                                   err_msg=k)
    assert repr(tc).split("(")[1] == repr(jc).split("(")[1]


def test_tree_bytes_and_spec_match_jax(rng):
    tree = _tree(rng)
    tree["e"] = rng.randint(0, 9, (3, 4)).astype(np.int32)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    assert codec.tree_bytes(ttree) == jcodec.tree_bytes(tree)
    assert codec.tree_spec(ttree) == jcodec.tree_spec(tree)
    bf = {k: v.to(torch.bfloat16) for k, v in ttree.items() if v.is_floating_point()}
    assert codec.tree_spec(bf) == jcodec.tree_spec({k: jnp.asarray(tree[k], jnp.bfloat16)
                                                    for k in bf})


def test_topk_breaks_an_exact_tie_by_the_lower_index():
    x = np.array([1.0, -3.0, 3.0, 0.5, -3.0, 3.0, 2.0, 0.0], np.float32)
    k = 3  # ceil(0.375 * 8): three of the four entries of magnitude 3
    jenc = jcodec.TopKCodec(0.375).encode({"w": jnp.asarray(x)}, None)
    tenc = codec.TopKCodec(0.375).encode({"w": torch.from_numpy(x)}, None)
    assert np.asarray(jenc.planes["indices"]["w"]).tolist() == [1, 2, 4]
    assert tenc.planes["indices"]["w"].tolist() == [1, 2, 4]
    assert codec.top_k_indices(torch.from_numpy(np.abs(x)), k).tolist() == [1, 2, 4]
    _assert_planes_equal(jenc, tenc)


@pytest.mark.parametrize("spec,kw", [
    ("", {}), ("topk+zip", {}), ("none+topk", {}), ("q3", {}), ("topk", {"topk_frac": 0.0}),
    ("quantize", {"quantize_bits": 2}),
])
def test_make_codec_errors_match_jax(spec, kw):
    with pytest.raises(Exception) as theirs:
        jcodec.make_codec(spec, **kw)
    with pytest.raises(Exception) as ours:
        codec.make_codec(spec, **kw)
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)


def test_chain_errors_match_jax():
    for stages in ([], [codec.NoneCodec(), codec.Bf16Codec()]):
        jstages = [jcodec.NoneCodec(), jcodec.Bf16Codec()] if stages else []
        with pytest.raises(ValueError) as theirs:
            jcodec.ChainCodec(jstages)
        with pytest.raises(ValueError) as ours:
            codec.ChainCodec(stages)
        assert str(ours.value) == str(theirs.value)
    assert [c.name for c in codec.make_codec("topk+q4", 0.1).stages] == ["topk0.1", "q4"]
    assert codec.make_codec("topk+q4").stages[0].value_dtype == torch.float32
    assert codec.make_codec("topk").value_dtype == torch.bfloat16


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizer_error_bound_and_unbiasedness(rng, bits):
    x = {"w": torch.from_numpy(rng.randn(257).astype(np.float32))}
    q = codec.QuantizeCodec(bits)
    scale = float(torch.max(torch.abs(x["w"])))
    decodes = []
    for r in range(400):
        dec = q.decode(q.encode(x, RoundNoise(11, r)))["w"]
        assert float(torch.max(torch.abs(dec - x["w"]))) <= scale / q.levels * (1 + 1e-6)
        decodes.append(dec.double())
    # each entry rounds up with probability p = y - floor(y): its mean over
    # N decodes has standard error sqrt(p (1 - p) / N) * scale / levels
    y = x["w"].double() / scale * q.levels
    p = y - torch.floor(y)
    se = torch.sqrt(p * (1 - p) / len(decodes)) * scale / q.levels
    gap = (torch.stack(decodes).mean(0) - x["w"].double()).abs()
    assert bool(torch.all(gap <= 4 * se + 1e-6)), float(((gap - 1e-6) / se).max())
    with pytest.raises(ValueError, match="uniform"):
        q.encode(x, None)


def test_error_feedback_residuals_match_jax_bitwise(rng):
    jc, tc = jcodec.make_codec("topk", topk_frac=0.05), codec.make_codec("topk", topk_frac=0.05)
    shapes = {"a": (40, 10), "b": (10,)}
    jres = jef.init({k: jnp.zeros(s) for k, s in shapes.items()})
    tres = ef.init({k: torch.zeros(s) for k, s in shapes.items()})
    j_step = jax.jit(lambda d, r: jef.encode_with_feedback(jc, jef.compensate(d, r), None))
    for _ in range(3):
        delta = _tree(rng, shapes)
        tcomp = ef.compensate({k: torch.from_numpy(v) for k, v in delta.items()}, tres)
        jenc, jdec, jres = j_step({k: jnp.asarray(v) for k, v in delta.items()}, jres)
        tenc, tdec, tres = ef.encode_with_feedback(tc, tcomp, None)
        _assert_planes_equal(jenc, tenc)
        for k in shapes:
            np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]), err_msg=k)
    assert ef.compensate(tres, None) is tres


def _flax_tree(rng, lead=()):
    def r(*shape):
        return rng.randn(*lead, *shape).astype(np.float32)

    return {"params": {"Dense_0": {"kernel": r(20, 6), "bias": r(6)},
                       "BatchNorm_0": {"scale": r(6), "bias": r(6)}},
            "batch_stats": {"BatchNorm_0": {"mean": r(6), "var": np.abs(r(6))}}}


def _close(j_tree, t_sd, atol=1e-6):
    back = convert.to_flax(t_sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(j_tree))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=atol, err_msg=str(path))


INNER = {
    "fedavg": (jax_fedavg, fedavg_aggregator),
    "fedadam": (lambda: jax_fedopt(jax_server_optimizer("adam", 0.1, 0.9)),
                lambda: fedopt_aggregator(server_optimizer("adam", 0.1, 0.9))),
    "median": (lambda: jax_robust(JaxRobustConfig(rule="median")),
               lambda: robust_aggregator(RobustConfig(rule="median"))),
}


def _client_draws(key, c, flax_like):
    """JAX's compressed aggregator's q8 uniforms for a round (client i
    encodes with ``split(fold_in(key, 0xC0DEC), c)[i]``, leaf by leaf in
    JAX's order), laid out as the port's leaves (a kernel's uniforms
    transposed with it) in the port's order: each element of the port's
    update meets the uniform JAX's same element meets."""
    leaves, treedef = jax.tree_util.tree_flatten(flax_like)
    sizes = [int(np.prod(np.shape(v))) for v in leaves]
    keys = jax.random.split(jax.random.fold_in(key, 0xC0DEC), c)
    all_draws = jax.jit(jax.vmap(lambda k: _quantizer_uniforms(k, sizes)))(keys)
    out = []
    for i in range(c):
        draws = [d[i] for d in all_draws]
        tree = jax.tree_util.tree_unflatten(
            treedef, [np.asarray(u).reshape(np.shape(v)) for u, v in zip(draws, leaves)])
        out += [t.reshape(-1) for t in convert.from_flax(tree).values()]
    return out


@pytest.mark.parametrize("inner,spec", [("fedavg", "topk"), ("fedadam", "topk"),
                                        ("median", "topk"), ("fedavg", "q8")])
def test_compressed_aggregator_matches_jax(rng, inner, spec):
    c = 5
    jmake, tmake = INNER[inner]
    jagg = jax_compressed(jcodec.make_codec(spec, topk_frac=0.1), jmake(), True, num_slots=c)
    tagg = compressed_aggregator(codec.make_codec(spec, topk_frac=0.1), tmake(), True,
                                 num_slots=c)
    assert tagg.name == jagg.name and not tagg.stacked
    j_global = jax.tree.map(jnp.asarray, _flax_tree(rng))
    t_global = convert.from_flax(jax.tree.map(np.asarray, j_global))
    j_state, t_state = jagg.init_state(j_global), tagg.init_state(t_global)
    weights = rng.randint(1, 20, c).astype(np.float32)
    weights[3] = 0.0  # out of the byte counts, in the stack
    for r in range(3):
        key = jax.random.key(r)
        stacked = _flax_tree(rng, lead=(c,))
        run = jagg.aggregate if inner == "fedadam" else jax.jit(jagg.aggregate)
        j_global, j_state, jm = run(
            j_global, jax.tree.map(jnp.asarray, stacked), jnp.asarray(weights), j_state, key)
        t_clients = [convert.from_flax(jax.tree.map(lambda a: a[i], stacked))
                     for i in range(c)]
        rng_stub = JaxUniforms(_client_draws(key, c, stacked_one(stacked)))
        t_global, t_state, tm = tagg.aggregate(t_global, iter(t_clients),
                                               torch.from_numpy(weights), t_state, rng_stub)
        _close(j_global, t_global)
        for i in range(c):
            _close(jax.tree.map(lambda a: a[i], j_state["residual"]),
                   {k: v[i] for k, v in t_state["residual"].items()})
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6, abs=1e-6), k
    one = codec.make_codec(spec, topk_frac=0.1).encode(t_global, RoundNoise(0, 0)).nbytes
    assert float(tm[metricslib.COMM_UPLINK_BYTES]) == 4 * one  # 4 of 5 weigh > 0


def stacked_one(stacked):
    return jax.tree.map(lambda a: a[0], stacked)


def test_compressed_aggregator_refuses_a_per_client_rule():
    with pytest.raises(NotImplementedError) as theirs:
        jax_compressed(jcodec.make_codec("topk"), _jax_gossip(), num_slots=4)
    with pytest.raises(NotImplementedError) as ours:
        compressed_aggregator(codec.make_codec("topk"), gossip_aggregator(np.eye(4)),
                              num_slots=4)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as theirs:
        jax_compressed(jcodec.make_codec("topk"))
    with pytest.raises(ValueError) as ours:
        compressed_aggregator(codec.make_codec("topk"))
    assert str(ours.value) == str(theirs.value)


def _jax_gossip():
    from fedml_tpu.algorithms.decentralized import gossip_aggregator as jax_gossip

    return jax_gossip(np.eye(4))


def _support(flax_tree):
    """The top-k support of a decoded update, leaf by leaf in flax's layout."""
    return {"/".join(str(p.key) for p in path): np.flatnonzero(np.asarray(leaf)).tolist()
            for path, leaf in jax.tree_util.tree_flatten_with_path(dict(flax_tree))[0]}


def test_make_local_update_matches_jax(rng):
    d, classes, S, B = 12, 4, 3, 5
    jtrainer = JaxTrainer(module=JaxLR(num_classes=classes), optimizer=optax.sgd(0.5), epochs=2)
    tmodule = create_model("lr", classes, "mnist", device="cpu", input_shape=(d,))
    ttrainer = ClientTrainer(module=tmodule, optimizer=sgd(0.5), epochs=2)
    data = {"x": rng.randn(S, B, d).astype(np.float32),
            "y": rng.randint(0, classes, (S, B)).astype(np.int32),
            "mask": np.ones((S, B), np.float32)}
    data["mask"][2, 3:] = 0.0
    j_vars = jtrainer.init(jax.random.key(0), jax.tree.map(lambda v: jnp.asarray(v[0]), data))
    t_vars = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    jc, tc = jcodec.make_codec("topk", topk_frac=0.2), codec.make_codec("topk", topk_frac=0.2)
    jupdate = jax.jit(jax_local_update(jtrainer, codec=jc))
    tupdate = make_local_update(ttrainer, codec=tc)
    jres, tres = jef.init(j_vars), ef.init(t_vars)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    for r in range(2):
        jenc, jres, jm = jupdate(j_vars, jax.tree.map(jnp.asarray, data), jax.random.key(r),
                                 jres)
        tenc, tres, tm = tupdate(t_vars, tdata, None, tres)
        jdec, tdec = jc.decode(jenc), tc.decode(tenc)
        assert _support(convert.to_flax(tdec)) == _support(jdec)
        _close(jdec, tdec)
        _close(jres, tres)
        for k in ("uplink_bytes", "uplink_dense_bytes"):
            assert float(tm[k]) == float(jm[k]), k
        assert float(tm["train_loss"]) == pytest.approx(float(jm["train_loss"]), abs=1e-6)
    # no codec: the raw delta, the residual passed through
    delta, res, _ = make_local_update(ttrainer, local_train_fn=lambda g, *a: (
        {k: 2 * v for k, v in g.items()}, {}))(t_vars, tdata, None, "carried")
    assert res == "carried"
    assert all(torch.equal(delta[k], v) for k, v in t_vars.items())  # 2v - v is exact


def test_feedback_over_a_running_variance_goes_negative_in_both_packages():
    """The JAX wrapper compresses every variable, BatchNorm statistics too,
    and error feedback carries a variance's dropped decrease into the next
    round on top of that round's own: a client whose running variance sits
    at 0.01 against a global 1.0 drives the kept entry to 1 - 2 x 0.99 < 0
    in round 2, in either package (an eval then normalises by the square
    root of a negative number)."""
    n = 100
    g = {"bn.running_var": np.ones(n, np.float32)}
    client = {"bn.running_var": np.full((1, n), 0.01, np.float32)}
    jagg = jax_compressed(jcodec.make_codec("topk", topk_frac=0.01), jax_fedavg(), True, 1)
    tagg = compressed_aggregator(codec.make_codec("topk", topk_frac=0.01), fedavg_aggregator(),
                                 True, 1)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    js, ts = jagg.init_state(jg), tagg.init_state(tg)
    for _ in range(2):
        jg, js, _ = jagg.aggregate(jg, {k: jnp.asarray(v) for k, v in client.items()},
                                   jnp.ones(1), js, jax.random.key(0))
        tg, ts, _ = tagg.aggregate(tg, iter([{k: torch.from_numpy(v[0])
                                               for k, v in client.items()}]),
                                   torch.ones(1), ts, None)
    want = np.asarray(jg["bn.running_var"])
    np.testing.assert_allclose(tg["bn.running_var"].numpy(), want, atol=1e-6)
    assert want.min() < 0 and tg["bn.running_var"].min() < 0
