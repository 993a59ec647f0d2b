"""The port's FedGKT (``models/resnet_gkt.py``, ``algorithms/fedgkt.py``,
``exp/main_fedgkt.py``) against the JAX package's, from the same variables
converted by ``convert.py``.

The JAX side runs in float64: under ``jax.enable_x64`` with float64
variables, and with its ResNet parts' compute dtype (the ``BasicBlock`` and
``_norm`` that ``fedml_tpu/models/resnet_gkt.py`` imports, fixed at f32
there) patched to float64 in the test, so the reference is the exact
function. The models' forwards hold the port's f32 to it, as the other
BatchNorm models' tests do (``tests/_torch_zoo.py``); the training phases
hold the port's float64 (the models' ``dtype``) to it: through four SGD
steps of conv and BatchNorm backward, f32 rounding alone moves a client
kernel element by 1.06e-4.

Tolerances:

- ``kl_loss`` on random logits: atol 1e-6;
- both models, evaluation and training forwards (the client's features
  compared after NHWC -> NCHW, the BatchNorm statistics too): atol 1e-4;
- ``client_train`` and ``server_train`` (each through its own jitted JAX
  phase), and a 2-round ``run_fedgkt`` of ``main_fedgkt``'s 2 clients (the
  synthetic_cv fixture), float64 both: the client models, the extracted
  features and logits, the server model and the server's logits per client
  atol 1e-4;
- the ``synthetic_cv`` copy: bitwise; ``main_fedgkt``'s ``Train/Acc`` from
  the JAX CLI's initial variables: equal to the JAX CLI's (f32 both).

The CLI's loopback arm is ``tests/test_torch_families_wire.py``'s.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedgkt as jgkt
from fedml_tpu.exp import main_fedgkt as jmain
from fedml_tpu.models import resnet as jresnet
from fedml_tpu.models import resnet_gkt as jmodels
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedgkt
from fedml_tpu_torch.exp import main_fedgkt
from fedml_tpu_torch.models.resnet_gkt import ResNetGKTClient, ResNetGKTServer

ATOL = 1e-4


@contextlib.contextmanager
def _jax_f64():
    """x64, and the JAX GKT models' ResNet parts computing in float64."""
    with jax.enable_x64(True), \
            mock.patch.object(jmodels, "BasicBlock",
                              functools.partial(jresnet.BasicBlock, dtype=jnp.float64)), \
            mock.patch.object(jmodels, "_norm",
                              lambda kind, train: jresnet._norm(kind, train, jnp.float64)):
        yield


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _close(want, got_sd, atol=ATOL, msg=""):
    back = convert.to_flax(got_sd, resnet=True)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(want))[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=atol, err_msg=f"{msg} {path}")


def _port(variables, dtype=torch.float32):
    return {k: v.to(dtype) for k, v in convert.from_flax(variables).items()}


def test_kl_loss_matches_jax(rng):
    s, t = rng.randn(6, 5).astype(np.float32) * 3, rng.randn(6, 5).astype(np.float32) * 3
    want = np.asarray(jgkt.kl_loss(jnp.asarray(s), jnp.asarray(t), 3.0))
    got = fedgkt.kl_loss(torch.tensor(s), torch.tensor(t), 3.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.all(fedgkt.kl_loss(torch.tensor(s), torch.tensor(s), 2.0).numpy() < 1e-6)


def _args(argv=()):
    return main_fedgkt.add_args(argparse.ArgumentParser()).parse_args(
        list(argv) + ["--device", "cpu"])


@pytest.fixture(scope="module")
def jax_gkt():
    """The JAX CLI's FedGKT (2 clients of synthetic_cv, 2 rounds) in
    float64: its initial variables, batches and what its phases return."""
    args = jmain.add_args(argparse.ArgumentParser()).parse_args([])
    train, classes = jmain._load_images(args)
    gkt = jgkt.FedGKT(jmodels.ResNetGKTClient(num_classes=classes, blocks=1),
                      jmodels.ResNetGKTServer(num_classes=classes, blocks_per_stage=1),
                      jgkt.optax.sgd(args.lr), jgkt.optax.sgd(args.lr))
    from fedml_tpu.sim.cohort import stack_cohort

    batches = [jax.tree.map(lambda v: np.asarray(v[0]), stack_cohort(train, np.asarray([c]),
                                                                     args.batch_size)[0])
               for c in range(train.num_clients)]
    out = {"train": train, "batches": batches, "gkt": gkt}
    with _jax_f64():
        init = _f64(gkt.init(jax.random.key(0), jnp.asarray(batches[0]["x"][0])))
        out["init"] = init
        jb = [jax.tree.map(jnp.asarray, b) for b in batches]
        s_logits = jnp.zeros(batches[0]["y"].shape + (classes,))
        c1, f1, l1 = jax.jit(gkt.client_train, static_argnums=3)(init[0], jb[0], s_logits, 1,
                                                                 jax.random.key(1))
        out["client"] = _f64((c1, f1, l1))
        sv, slog = jax.jit(gkt.server_train, static_argnums=5)(
            init[1], f1, l1, jb[0]["y"], jb[0]["mask"], 1)
        out["server"] = _f64((sv, slog))
        with mock.patch.object(gkt, "init", lambda rng, x: init):
            out["run"] = _f64(jgkt.run_fedgkt(gkt, jb, 2, 1, 1, jax.random.key(0)))
    return out


def test_models_match_jax(jax_gkt):
    cvars, svars = jax_gkt["init"]
    x = jax_gkt["batches"][0]["x"][0]
    client, server = ResNetGKTClient(4, device="cpu"), ResNetGKTServer(4, 1, device="cpu")
    client.load_state_dict(_port(cvars))
    server.load_state_dict(_port(svars))
    jc, js = jax_gkt["gkt"].client_module, jax_gkt["gkt"].server_module
    with _jax_f64():
        (jf, jl), jstate = jc.apply(cvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
        jf_eval, jl_eval = jc.apply(cvars, jnp.asarray(x))
        js_logits, js_state = js.apply(svars, jf_eval, train=True, mutable=["batch_stats"])
        js_eval = js.apply(svars, jf_eval)
    with torch.no_grad():
        (tf, tl), tstate = client(torch.tensor(x), train=True)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf).transpose(0, 3, 1, 2),
                               atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _close(_f64({"batch_stats": jstate["batch_stats"]}), tstate, msg="client stats")
    with torch.no_grad():
        tf_eval, tl_eval = client(torch.tensor(x))
    np.testing.assert_allclose(tf_eval.numpy(), np.asarray(jf_eval).transpose(0, 3, 1, 2),
                               atol=ATOL)
    np.testing.assert_allclose(tl_eval.numpy(), np.asarray(jl_eval), atol=ATOL)
    feats = torch.tensor(np.asarray(jf_eval, np.float32).transpose(0, 3, 1, 2))
    with torch.no_grad():
        ts_logits, ts_state = server(feats, train=True)
    np.testing.assert_allclose(ts_logits.numpy(), np.asarray(js_logits), atol=ATOL)
    _close(_f64({"batch_stats": js_state["batch_stats"]}), ts_state, msg="server stats")
    with torch.no_grad():
        np.testing.assert_allclose(server(feats).numpy(), np.asarray(js_eval), atol=ATOL)


def _port_gkt():
    """``main_fedgkt``'s FedGKT and batches, its models in float64."""
    gkt, batches = main_fedgkt.build(_args(), torch.device("cpu"))
    f64 = torch.float64
    return dataclasses.replace(
        gkt, client_module=ResNetGKTClient(4, blocks=1, dtype=f64, device="cpu"),
        server_module=ResNetGKTServer(4, 1, dtype=f64, device="cpu")), batches


def test_client_and_server_phases_match_jax(jax_gkt):
    gkt, batches = _port_gkt()
    for k, v in batches[0].items():
        np.testing.assert_array_equal(v.numpy(), jax_gkt["batches"][0][k])
    cvars, svars = (_port(v, torch.float64) for v in jax_gkt["init"])
    zeros = torch.zeros(batches[0]["y"].shape + (4,), dtype=torch.float64)
    c1, f1, l1 = gkt.client_train(cvars, batches[0], zeros, 1)
    jc, jf, jl = jax_gkt["client"]
    _close(jc, c1, msg="client")
    np.testing.assert_allclose(f1.numpy(), jf.transpose(0, 1, 4, 2, 3), atol=ATOL)
    np.testing.assert_allclose(l1.numpy(), jl, atol=ATOL)
    # the server phase from the JAX client's outputs
    sv, slog = gkt.server_train(svars, torch.tensor(jf.transpose(0, 1, 4, 2, 3)),
                                torch.tensor(jl), batches[0]["y"], batches[0]["mask"], 1)
    jsv, jslog = jax_gkt["server"]
    _close(jsv, sv, msg="server")
    np.testing.assert_allclose(slog.numpy(), jslog, atol=ATOL)


def test_run_fedgkt_matches_jax(jax_gkt):
    gkt, batches = _port_gkt()
    start = tuple(_port(v, torch.float64) for v in jax_gkt["init"])
    with mock.patch.object(fedgkt.FedGKT, "init", lambda self, generator: start):
        cvars, svars, slogits = fedgkt.run_fedgkt(gkt, batches, 2, 1, 1, None)
    j_cvars, j_svars, j_slogits = jax_gkt["run"]
    for c in range(2):
        _close(j_cvars[c], cvars[c], msg=f"client {c}")
        np.testing.assert_allclose(slogits[c].numpy(), j_slogits[c], atol=ATOL)
    _close(j_svars, svars, msg="server")


def test_synthetic_cv_copy_and_cli_match_jax(jax_gkt):
    args = _args()
    train, classes = main_fedgkt._load_images(args)
    assert classes == 4
    for k in ("x", "y"):
        np.testing.assert_array_equal(train.arrays[k], jax_gkt["train"].arrays[k])
        assert train.arrays[k].dtype == jax_gkt["train"].arrays[k].dtype
    assert {c: list(v) for c, v in train.partition.items()} == {
        c: list(v) for c, v in jax_gkt["train"].partition.items()}
    seen = {}
    run = jgkt.run_fedgkt

    def recording(gkt, client_batches, **kw):
        seen["init"] = jax.tree.map(np.asarray, gkt.init(kw["rng"], client_batches[0]["x"][0]))
        return run(gkt, client_batches, **kw)

    with mock.patch.object(jgkt, "run_fedgkt", recording):
        want = jmain.main([])
    start = tuple(_port(v) for v in seen["init"])
    with mock.patch.object(fedgkt.FedGKT, "init", lambda self, generator: start):
        got = main_fedgkt.run(args)
    assert got == want
