"""The port's split-learning families over the comm layer
(``algorithms/splitnn_dist.py``, ``vertical_dist.py``, ``fedgkt_dist.py`` and
the ``--backend`` arms of ``exp/main_splitnn``, ``main_vfl``,
``main_fedgkt``) against their in-process oracles and against the JAX
package's, the mirror of ``tests/test_comm_pipelines.py``. Every threaded
run has a deadline of its own (``_within_deadline``).

Tolerances:

- each family's wire run (loopback; split also over shm, gRPC and client
  processes) against its port oracle (``run_splitnn_relay_stepwise``,
  ``run_vfl_stepwise``, ``run_fedgkt``): bitwise, the losses too;
- the port's stepwise oracles against its single programs: SplitNN's
  variables bitwise and its turn losses rtol 1e-6 / atol 1e-7 (the mean
  of the stacked step losses against the fused relay's running sum over
  S, the JAX test's bound); VFL bitwise;
- port runs and mixed federations (a JAX server with port clients, a port
  server with JAX clients) against the all-JAX run from the same start:
  SplitNN and VFL atol 1e-5 (``tests/test_torch_split_vertical.py``'s
  bound: f32 products summed in other orders), FedGKT atol 1e-4
  (``tests/test_torch_fedgkt.py``'s: both packages in float64, the JAX
  GKT blocks' compute dtype patched to float64 process-wide for the run,
  as its threads run JAX too), the GKT features crossing in the JAX
  ``[S, B, H, W, F]`` layout;
- the CLIs' wire arms against the JAX CLI's from the JAX run's initial
  variables: ``Train/Loss`` atol 1e-5 and ``Test/Acc`` equal (split,
  VFL), ``Train/Acc`` equal (GKT, f32 both, as ``test_torch_fedgkt``).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse
import contextlib
import functools
import os
import socket
import subprocess
import sys
import threading
import uuid
from pathlib import Path
from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import fedgkt as jgkt
from fedml_tpu.algorithms import fedgkt_dist as jgd
from fedml_tpu.algorithms import splitnn as jsplit
from fedml_tpu.algorithms import splitnn_dist as jsd
from fedml_tpu.algorithms import vertical as jvert
from fedml_tpu.algorithms import vertical_dist as jvd
from fedml_tpu.comm import loopback as jloopback
from fedml_tpu.data.synthetic import gaussian_blobs as jblobs
from fedml_tpu.exp import main_fedgkt as jmain_gkt
from fedml_tpu.exp import main_splitnn as jmain_split
from fedml_tpu.exp import main_vfl as jmain_vfl
from fedml_tpu.models import resnet as jresnet
from fedml_tpu.models import resnet_gkt as jmodels
from fedml_tpu.sim.cohort import stack_cohort as jstack
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedgkt, splitnn, vertical
from fedml_tpu_torch.algorithms import fedgkt_dist as gd
from fedml_tpu_torch.algorithms import splitnn_dist as sd
from fedml_tpu_torch.algorithms import vertical_dist as vd
from fedml_tpu_torch.algorithms.fedavg_distributed import run_manager_protocol
from fedml_tpu_torch.comm import loopback as tloopback
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core.trainer import sgd
from fedml_tpu_torch.data.synthetic import gaussian_blobs
from fedml_tpu_torch.exp import main_fedgkt, main_splitnn, main_vfl
from fedml_tpu_torch.models.resnet_gkt import ResNetGKTClient, ResNetGKTServer
from fedml_tpu_torch.sim.cohort import stack_cohort
from tests.test_torch_fedavg_dist import _within_deadline

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
GKT_ATOL = 1e-4


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _assert_bitwise(want, got):
    """Two ``(client variables per client, server variables, ...)`` runs
    bitwise equal (the trailing losses too, when given)."""
    assert all(_equal(a, b) for a, b in zip(want[0], got[0])), "client variables differ"
    assert _equal(want[1], got[1]), "server variables differ"
    if len(want) > 2:
        assert want[2] == got[2]


def _close(want_tree, got_sd, atol, msg="", resnet=None):
    """A port state dict within ``atol`` of JAX variables, in their layout."""
    back = convert.to_flax({k: v.detach().cpu() for k, v in got_sd.items()}, resnet=resnet)
    leaves = jax.tree_util.tree_flatten_with_path(dict(want_tree))[0]
    assert len(leaves) == len(jax.tree.leaves(back))
    for path, leaf in leaves:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=atol, err_msg=f"{msg} {path}")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fabric(n):
    return tloopback.LoopbackFabric(n)


def _run(server, clients, fabric):
    _within_deadline(lambda: run_manager_protocol(server, clients), [fabric])


# -- SplitNN ---------------------------------------------------------------------


class _JBottom(nn.Module):
    hidden: int = 12

    @nn.compact
    def __call__(self, x, train: bool = False):
        return nn.relu(nn.Dense(self.hidden)(x.astype(jnp.float32)))


class _JTop(nn.Module):
    classes: int = 4

    @nn.compact
    def __call__(self, acts, train: bool = False):
        return nn.Dense(self.classes)(acts)


def _port_split():
    return splitnn.SplitNN(main_splitnn.Bottom(16, 12, "cpu"), main_splitnn.Top(12, 4, "cpu"),
                           sgd(0.2), sgd(0.2))


def _split_batches(n_clients=3, batch=10):
    """The JAX test's setup (``_split_setup``): each client's ``[S, B, ...]``
    stack of the blob fixture, port tensors and JAX arrays."""
    train, _ = gaussian_blobs(n_clients=n_clients, samples_per_client=4 * batch, num_classes=4,
                              seed=0)
    jtrain, _ = jblobs(n_clients=n_clients, samples_per_client=4 * batch, num_classes=4, seed=0)
    port, jx = [], []
    for c in range(n_clients):
        stack, _ = stack_cohort(train, np.asarray([c]), batch_size=batch)
        jst, _ = jstack(jtrain, np.asarray([c]), batch_size=batch)
        for k in jst:
            np.testing.assert_array_equal(stack[k], jst[k])
        port.append({k: torch.as_tensor(v[0]) for k, v in stack.items()})
        jx.append(jax.tree.map(lambda v: jnp.asarray(v[0]), jst))
    return port, jx


def test_split_stepwise_matches_single_program():
    split, (cb, _) = _port_split(), _split_batches()
    cv1, sv1, l1 = splitnn.run_splitnn_relay(split, cb, 2, rnglib.generator(0))
    cv2, sv2, l2 = sd.run_splitnn_relay_stepwise(split, cb, 2, rnglib.generator(0))
    _assert_bitwise((cv1, sv1), (cv2, sv2))
    np.testing.assert_allclose(l1, l2, rtol=1e-6, atol=1e-7)


def test_split_loopback_matches_stepwise():
    split, (cb, _) = _port_split(), _split_batches()
    want = sd.run_splitnn_relay_stepwise(split, cb, 2, rnglib.generator(0))
    got = _within_deadline(lambda: sd.run_distributed_splitnn_loopback(
        split, cb, 2, rnglib.generator(0)), [])
    _assert_bitwise(want, got)


def test_split_over_shm_ring():
    split, (cb, _) = _port_split(), _split_batches(n_clients=2)
    want = sd.run_splitnn_relay_stepwise(split, cb, 1, rnglib.generator(0))
    got = _within_deadline(lambda: sd.run_distributed_splitnn_shm(
        split, cb, 1, rnglib.generator(0)), [])
    _assert_bitwise(want, got)


def test_split_over_grpc():
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

    split, (cb, _) = _port_split(), _split_batches(n_clients=2)
    want = sd.run_splitnn_relay_stepwise(split, cb, 1, rnglib.generator(0))
    mgrs = {}
    try:
        for attempt in range(3):  # a lost bind race retries the whole set
            try:
                socks = [socket.socket() for _ in range(len(cb) + 1)]
                for s in socks:
                    s.bind(("127.0.0.1", 0))
                cfg = {r: ("127.0.0.1", s.getsockname()[1]) for r, s in enumerate(socks)}
                for s in socks:
                    s.close()
                for r in cfg:
                    mgrs[r] = GRPCCommManager(r, cfg)
                break
            except OSError:
                for m in mgrs.values():
                    m.stop_receive_message()
                mgrs = {}
                if attempt == 2:
                    raise
        got = _within_deadline(lambda: sd.run_distributed_splitnn(
            split, cb, 1, rnglib.generator(0), lambda r: mgrs[r]), [])
    finally:
        for m in mgrs.values():
            m.stop_receive_message()
    _assert_bitwise(want, got)


_CLIENT_PROCESS = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from fedml_tpu_torch.algorithms.splitnn import SplitNN
from fedml_tpu_torch.algorithms.splitnn_dist import SplitNNClientManager
from fedml_tpu_torch.comm.shm import ShmCommManager
from fedml_tpu_torch.core.trainer import sgd
from fedml_tpu_torch.exp.main_splitnn import Bottom, Top
job, rank, world, path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
data = np.load(path)
batches = {k: torch.from_numpy(data[k]) for k in data.files}
split = SplitNN(Bottom(16, 12, "cpu"), Top(12, 4, "cpu"), sgd(0.2), sgd(0.2))
comm = ShmCommManager(job, rank, world)
SplitNNClientManager(comm, rank, world, split, batches).run()
comm.cleanup()
"""


def test_split_client_processes(tmp_path):
    """Each client a process of its own over the shm rings against this
    process's server (the reference's process model), bitwise the
    oracle."""
    split, (cb, _) = _port_split(), _split_batches(n_clients=2)
    want = sd.run_splitnn_relay_stepwise(split, cb, 1, rnglib.generator(0))
    job = f"sp_{uuid.uuid4().hex[:8]}"
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    workers = []
    for r, batches in enumerate(cb, start=1):
        npz = tmp_path / f"client{r}.npz"
        np.savez(npz, **{k: v.numpy() for k, v in batches.items()})
        workers.append(subprocess.Popen(
            [sys.executable, "-c", _CLIENT_PROCESS, job, str(r), str(len(cb) + 1), str(npz)],
            cwd=ROOT, env=env))
    from fedml_tpu_torch.comm.shm import ShmCommManager

    cvars0, svars = split.init(rnglib.generator(0))
    comm = ShmCommManager(job, 0, len(cb) + 1)
    server = sd.SplitNNServerManager(comm, split, len(cb), 1, 0, cvars0, svars)
    done = threading.Event()

    def watchdog():
        # a child that dies before FINAL_VARS would leave the receive loop
        # waiting: stop it so the test fails instead of hanging
        while not done.wait(1.0):
            if any(w.poll() is not None and w.returncode != 0 for w in workers):
                server.finish()
                return

    threading.Thread(target=watchdog, daemon=True).start()
    try:
        server.register_message_receive_handlers()
        server.send_init_msg()
        server.comm.handle_receive_message()
        done.set()
        assert len(server.final_cvars) == len(cb), "a client process died mid-protocol"
        for w in workers:
            assert w.wait(timeout=120) == 0
    finally:
        done.set()
        for w in workers:
            if w.poll() is None:
                w.kill()
        comm.cleanup()
    got = ([server.final_cvars[r] for r in range(1, len(cb) + 1)], server.svars, server.losses)
    _assert_bitwise(want, got)


@pytest.fixture(scope="module")
def jax_split():
    """The all-JAX loopback run (3 clients, 2 epochs) and its start."""
    _, jcb = _split_batches()
    split = jsplit.SplitNN(_JBottom(), _JTop(), optax.sgd(0.2), optax.sgd(0.2))
    init = _np(split.init(jax.random.key(0), jcb[0]["x"][0]))
    out = jsd.run_distributed_splitnn_loopback(split, jcb, epochs=2, rng=jax.random.key(0))
    return {"split": split, "batches": jcb, "init": init, "out": _np(out)}


@pytest.mark.parametrize("parties", ["port", "jax_server", "port_server"])
def test_split_wire_and_mixed_federations_reach_jax(jax_split, parties):
    """The all-port wire run from the JAX start, a JAX server with port
    clients and a port server with JAX clients, against the all-JAX run."""
    cb, jcb = _split_batches()
    port, jax_ = _port_split(), jax_split["split"]
    cvars0, svars0 = jax_split["init"]
    start = (convert.from_flax(cvars0), convert.from_flax(svars0))
    n, fabric = len(cb), _fabric(len(cb) + 1)
    if parties == "port":
        with mock.patch.object(splitnn.SplitNN, "init", lambda self, g: start):
            cvars, svars, losses = _within_deadline(lambda: sd.run_distributed_splitnn(
                port, cb, 2, None, lambda r: tloopback.LoopbackCommManager(fabric, r)),
                [fabric])
    elif parties == "jax_server":
        server = jsd.SplitNNServerManager(jloopback.LoopbackCommManager(fabric, 0), jax_, n, 2,
                                          jax.random.key(0), cvars0, svars0)
        clients = [sd.SplitNNClientManager(tloopback.LoopbackCommManager(fabric, r), r, n + 1,
                                           port, cb[r - 1]) for r in range(1, n + 1)]
        _run(server, clients, fabric)
        cvars = [convert.from_flax(_np(server.final_cvars[r])) for r in range(1, n + 1)]
        svars, losses = convert.from_flax(_np(server.svars)), server.losses
    else:
        server = sd.SplitNNServerManager(tloopback.LoopbackCommManager(fabric, 0), port, n, 2,
                                         0, *start)
        clients = [jsd.SplitNNClientManager(jloopback.LoopbackCommManager(fabric, r), r, n + 1,
                                            jax_, jcb[r - 1]) for r in range(1, n + 1)]
        _run(server, clients, fabric)
        cvars = [server.final_cvars[r] for r in range(1, n + 1)]
        svars, losses = server.svars, server.losses
    j_cvars, j_svars, j_losses = jax_split["out"]
    assert len(losses) == len(j_losses) == 6
    np.testing.assert_allclose(losses, j_losses, atol=ATOL)
    for c in range(n):
        _close(j_cvars[c], cvars[c], ATOL, f"{parties} client {c}")
    _close(j_svars, svars, ATOL, f"{parties} server")


SPLIT_ARGV = ["--client_number", "3", "--epochs", "2"]


@pytest.fixture(scope="module")
def jax_split_cli():
    """The JAX CLI's loopback run and its start."""
    seen = {}
    runner = jsd.run_distributed_splitnn_loopback

    def recording(split, client_batches, epochs, rng):
        seen["init"] = _np(split.init(rng, client_batches[0]["x"][0]))
        return runner(split, client_batches, epochs, rng)

    with mock.patch.object(jsd, "run_distributed_splitnn_loopback", recording):
        seen["metrics"] = jmain_split.main(SPLIT_ARGV + ["--backend", "loopback"])
    return seen


@pytest.mark.parametrize("backend", ["loopback", "shm"])
def test_split_cli_wire_arms_match_jax(jax_split_cli, backend):
    start = tuple(convert.from_flax(v) for v in jax_split_cli["init"])
    with mock.patch.object(splitnn.SplitNN, "init", lambda self, g: start):
        got = _within_deadline(lambda: main_splitnn.main(
            SPLIT_ARGV + ["--backend", backend, "--device", "cpu"]), [])
        inprocess = main_splitnn.main(SPLIT_ARGV + ["--device", "cpu"])
    want = jax_split_cli["metrics"]
    assert set(got) == set(want) == {"Train/Loss", "Test/Acc"}
    np.testing.assert_allclose(got["Train/Loss"], want["Train/Loss"], atol=ATOL)
    assert got["Test/Acc"] == want["Test/Acc"] == inprocess["Test/Acc"]
    np.testing.assert_allclose(got["Train/Loss"], inprocess["Train/Loss"], rtol=1e-6, atol=1e-7)


# -- vertical FL -----------------------------------------------------------------


def _vfl_setup(n_parties=3):
    """The JAX test's ``_vfl_setup``: 200 rows of 20 columns cut in
    ``n_parties`` blocks, a linear label."""
    rng = np.random.RandomState(0)
    n, d = 200, 20
    x = rng.randn(n, d).astype(np.float32)
    y = (x @ rng.randn(d) > 0).astype(np.int32)
    cuts = np.linspace(0, d, n_parties + 1).astype(int)
    splits = [x[:, cuts[i]:cuts[i + 1]] for i in range(n_parties)]
    vfl = vertical.VerticalFL([vertical.PartyModel(s.shape[1], hidden=16, device="cpu")
                               for s in splits], sgd(0.3))
    return vfl, splits, y


def _torch(arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_vfl_stepwise_matches_single_program():
    _, splits, y = _vfl_setup()
    vfl, pv1, l1 = vertical.run_vfl(_torch(splits), torch.as_tensor(y), epochs=2,
                                    batch_size=40, lr=0.3, hidden=16, seed=0)
    pv2, l2 = vd.run_vfl_stepwise(vfl, _torch(splits), torch.as_tensor(y), 2, 40,
                                  rnglib.generator(0))
    assert all(_equal(a, b) for a, b in zip(pv1, pv2))
    assert l1 == l2


def test_vfl_loopback_matches_stepwise():
    vfl, splits, y = _vfl_setup()
    pv1, l1 = vd.run_vfl_stepwise(vfl, _torch(splits), torch.as_tensor(y), 2, 40,
                                  rnglib.generator(0))
    pv2, l2 = _within_deadline(lambda: vd.run_distributed_vfl_loopback(
        vfl, _torch(splits), torch.as_tensor(y), 2, 40, rnglib.generator(0)), [])
    assert all(_equal(a, b) for a, b in zip(pv1, pv2))
    assert l1 == l2


def test_vfl_stale_logits_resend_guard():
    """A stale H2G logits message re-announces the current step to that
    host only while its answer for the current step is outstanding; a late
    duplicate after it answered is dropped (the JAX test's sequence)."""
    class _RecordingComm:
        def __init__(self):
            self.sent = []

        def add_observer(self, obs):
            pass

        def send_message(self, msg):
            self.sent.append(msg)

    vfl, splits, y = _vfl_setup()
    comm = _RecordingComm()
    guest = vd.VFLGuestManager(comm, vfl, vfl.init(rnglib.generator(0)),
                               torch.as_tensor(splits[0]), torch.as_tensor(y), batch_size=40,
                               epochs=1)

    def h2g(host, step):
        msg = Message(vd.VFLMsg.MSG_TYPE_H2G_LOGITS, host, 0)
        msg.add_params(vd.VFLMsg.KEY_STEP, step)
        msg.add_params(vd.VFLMsg.KEY_LOGITS, np.zeros(40, np.float32))
        return msg

    # host 2's answer for the current step is outstanding: re-announce once
    guest._on_logits(h2g(2, guest.step + 5))
    assert len(comm.sent) == 1
    assert comm.sent[0].get_receiver_id() == 2
    assert int(comm.sent[0].get(vd.VFLMsg.KEY_STEP)) == guest.step
    # after host 2 answers the current step, a late duplicate is dropped
    guest._on_logits(h2g(2, guest.step))
    guest._on_logits(h2g(2, guest.step + 5))
    assert len(comm.sent) == 1
    # a duplicate landing after the step advanced is dropped too
    answered = guest.step
    guest.step += 1
    guest._step_logits = {}
    guest._on_logits(h2g(2, answered))
    assert len(comm.sent) == 1
    # ...while a never-accepted stale answer still re-announces
    guest._on_logits(h2g(1, answered))
    assert len(comm.sent) == 2
    assert comm.sent[1].get_receiver_id() == 1
    assert int(comm.sent[1].get(vd.VFLMsg.KEY_STEP)) == guest.step


@pytest.fixture(scope="module")
def jax_vfl():
    """The all-JAX loopback VFL run (3 parties, 2 epochs) and its start."""
    _, splits, y = _vfl_setup()
    vfl = jvert.VerticalFL([jvert.PartyModel(hidden=16) for _ in splits], optax.sgd(0.3))
    fs = [jnp.asarray(s) for s in splits]
    init = _np(vfl.init(jax.random.key(0), fs))
    out = jvd.run_distributed_vfl_loopback(vfl, fs, jnp.asarray(y), 2, 40, jax.random.key(0))
    return {"vfl": vfl, "init": init, "out": _np(out)}


@pytest.mark.parametrize("parties", ["port", "jax_guest", "port_guest"])
def test_vfl_wire_and_mixed_federations_reach_jax(jax_vfl, parties):
    vfl, splits, y = _vfl_setup()
    start = [convert.from_flax(v) for v in jax_vfl["init"]]
    n, fabric = len(splits), _fabric(len(splits))
    jfs = [jnp.asarray(s) for s in splits]
    if parties == "port":
        with mock.patch.object(vertical.VerticalFL, "init", lambda self, g: start):
            pvars, losses = _within_deadline(lambda: vd.run_distributed_vfl(
                vfl, _torch(splits), torch.as_tensor(y), 2, 40, None,
                lambda r: tloopback.LoopbackCommManager(fabric, r)), [fabric])
    elif parties == "jax_guest":
        guest = jvd.VFLGuestManager(jloopback.LoopbackCommManager(fabric, 0), jax_vfl["vfl"],
                                    jax.tree.map(jnp.asarray, jax_vfl["init"]), jfs[0],
                                    jnp.asarray(y), 40, 2)
        hosts = [vd.VFLHostManager(tloopback.LoopbackCommManager(fabric, h), h, n, vfl,
                                   torch.as_tensor(splits[h]), 40, 2) for h in range(1, n)]
        _run(guest, hosts, fabric)
        pvars = [convert.from_flax(_np(v)) for v in
                 [guest.gvars] + [guest.final_pvars[h] for h in range(1, n)]]
        losses = guest.losses
    else:
        guest = vd.VFLGuestManager(tloopback.LoopbackCommManager(fabric, 0), vfl, start,
                                   torch.as_tensor(splits[0]), torch.as_tensor(y), 40, 2)
        hosts = [jvd.VFLHostManager(jloopback.LoopbackCommManager(fabric, h), h, n,
                                    jax_vfl["vfl"], jfs[h], 40, 2) for h in range(1, n)]
        _run(guest, hosts, fabric)
        pvars = [guest.gvars] + [guest.final_pvars[h] for h in range(1, n)]
        losses = guest.losses
    j_pvars, j_losses = jax_vfl["out"]
    assert len(losses) == len(j_losses) == 2 * (200 // 40)
    np.testing.assert_allclose(losses, j_losses, atol=ATOL)
    for p in range(n):
        _close(j_pvars[p], pvars[p], ATOL, f"{parties} party {p}")


def test_vfl_cli_loopback_matches_jax():
    seen = {}
    runner = jvd.run_distributed_vfl_loopback

    def recording(vfl, splits, y, epochs, batch_size, rng):
        seen["init"] = _np(vfl.init(rng, splits))
        return runner(vfl, splits, y, epochs, batch_size, rng)

    argv = ["--epochs", "2", "--backend", "loopback"]
    with mock.patch.object(jvd, "run_distributed_vfl_loopback", recording):
        want = jmain_vfl.main(argv)
    start = [convert.from_flax(v) for v in seen["init"]]
    with mock.patch.object(vertical.VerticalFL, "init", lambda self, g: start):
        got = _within_deadline(lambda: main_vfl.main(argv + ["--device", "cpu"]), [])
        inprocess = main_vfl.main(["--epochs", "2", "--device", "cpu"])
    np.testing.assert_allclose(got["Train/Loss"], want["Train/Loss"], atol=ATOL)
    assert got["Test/Acc"] == want["Test/Acc"]
    assert got == inprocess  # the wire arm is the in-process arm's run, bitwise


# -- FedGKT ----------------------------------------------------------------------


@contextlib.contextmanager
def _jax_f64():
    """x64 process-wide (the wire's JAX parties run in threads) and the JAX
    GKT models' ResNet parts computing in float64."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with mock.patch.object(jmodels, "BasicBlock",
                               functools.partial(jresnet.BasicBlock, dtype=jnp.float64)), \
                mock.patch.object(jmodels, "_norm",
                                  lambda kind, train: jresnet._norm(kind, train, jnp.float64)):
            yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _gkt_args(argv=()):
    return main_fedgkt.add_args(argparse.ArgumentParser()).parse_args(
        list(argv) + ["--device", "cpu"])


def _port_gkt(dtype=torch.float64):
    """``main_fedgkt``'s FedGKT (its models in ``dtype``) and batches."""
    gkt, batches = main_fedgkt.build(_gkt_args(), torch.device("cpu"))
    return fedgkt.FedGKT(ResNetGKTClient(4, blocks=1, dtype=dtype, device="cpu"),
                         ResNetGKTServer(4, 1, dtype=dtype, device="cpu"), gkt.client_opt,
                         gkt.server_opt, gkt.temperature, gkt.alpha), batches


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _port_vars(variables, dtype=torch.float64):
    return {k: v.to(dtype) for k, v in convert.from_flax(variables, resnet=True).items()}


def test_gkt_loopback_matches_inprocess():
    """Two rounds (the server's logits cross the wire too): bitwise
    ``run_fedgkt``."""
    gkt, batches = _port_gkt(torch.float32)
    cv1, sv1, _ = fedgkt.run_fedgkt(gkt, batches, 2, 1, 1, rnglib.generator(0))
    stats = {}
    cv2, sv2 = _within_deadline(lambda: gd.run_distributed_fedgkt_loopback(
        gkt, batches, 2, 1, 1, rnglib.generator(0), stats=stats), [])
    _assert_bitwise((cv1, sv1), (cv2, sv2))
    # [S, B, F, H, W] of 8x8 images, f32: every client's upload each round
    per_round = sum(b["x"].shape[0] * b["x"].shape[1] for b in batches) * 16 * 8 * 8 * 4
    assert [r["feature_bytes"] for r in stats["rounds"]] == [per_round] * 2


@pytest.fixture(scope="module")
def jax_gkt():
    """The all-JAX in-process run of ``main_fedgkt``'s setup in float64
    (``test_comm_pipelines`` holds the JAX loopback run bitwise to it), its
    start and batches."""
    args = jmain_gkt.add_args(argparse.ArgumentParser()).parse_args([])
    train, classes = jmain_gkt._load_images(args)
    gkt = jgkt.FedGKT(jmodels.ResNetGKTClient(num_classes=classes, blocks=1),
                      jmodels.ResNetGKTServer(num_classes=classes, blocks_per_stage=1),
                      optax.sgd(args.lr), optax.sgd(args.lr))
    batches = [jax.tree.map(lambda v: np.asarray(v[0]),
                            jstack(train, np.asarray([c]), args.batch_size)[0])
               for c in range(train.num_clients)]
    with _jax_f64():
        init = _f64(gkt.init(jax.random.key(0), jnp.asarray(batches[0]["x"][0])))
        jb = [jax.tree.map(lambda v: jnp.asarray(v.astype(np.float64)
                                                 if v.dtype == np.float32 else v), b)
              for b in batches]
        with mock.patch.object(gkt, "init", lambda rng, x: init):
            cv, sv, _ = jgkt.run_fedgkt(gkt, jb, 2, 1, 1, jax.random.key(0))
        out = _f64((cv, sv))
    return {"gkt": gkt, "init": init, "batches": jb, "out": out}


@pytest.mark.parametrize("parties", ["port", "jax_server", "port_server"])
def test_gkt_wire_and_mixed_federations_reach_jax(jax_gkt, parties):
    """float64 both: features cross in the JAX layout between the
    packages."""
    gkt, batches = _port_gkt()
    batches = [{k: v.double() if v.is_floating_point() else v for k, v in b.items()}
               for b in batches]
    cvars0, svars0 = jax_gkt["init"]
    start = (_port_vars(cvars0), _port_vars(svars0))
    n, fabric = len(batches), _fabric(len(batches) + 1)
    with _jax_f64():
        if parties == "port":
            with mock.patch.object(fedgkt.FedGKT, "init", lambda self, g: start):
                cvars, svars = _within_deadline(lambda: gd.run_distributed_fedgkt(
                    gkt, batches, 2, 1, 1, None,
                    lambda r: tloopback.LoopbackCommManager(fabric, r)), [fabric])
        elif parties == "jax_server":
            server = jgd.GKTServerManager(jloopback.LoopbackCommManager(fabric, 0),
                                          jax_gkt["gkt"], n, 2, 1, jax.random.key(0),
                                          cvars0, svars0)
            clients = [gd.GKTClientManager(tloopback.LoopbackCommManager(fabric, r), r, n + 1,
                                           gkt, batches[r - 1], 1) for r in range(1, n + 1)]
            _run(server, clients, fabric)
            cvars = [_port_vars(_np(server.final_cvars[r])) for r in range(1, n + 1)]
            svars = _port_vars(_np(server.svars))
        else:
            server = gd.GKTServerManager(tloopback.LoopbackCommManager(fabric, 0), gkt, n, 2, 1,
                                         0, *start)
            clients = [jgd.GKTClientManager(jloopback.LoopbackCommManager(fabric, r), r, n + 1,
                                            jax_gkt["gkt"], jax_gkt["batches"][r - 1], 1)
                       for r in range(1, n + 1)]
            _run(server, clients, fabric)
            cvars = [server.final_cvars[r] for r in range(1, n + 1)]
            svars = server.svars
    j_cvars, j_svars = jax_gkt["out"]
    for c in range(n):
        _close(j_cvars[c], cvars[c], GKT_ATOL, f"{parties} client {c}", resnet=True)
    _close(j_svars, svars, GKT_ATOL, f"{parties} server", resnet=True)


def test_gkt_cli_loopback_matches_jax():
    seen = {}
    runner = jgd.run_distributed_fedgkt_loopback

    def recording(gkt, client_batches, **kw):
        seen["init"] = _np(gkt.init(kw["rng"], client_batches[0]["x"][0]))
        return runner(gkt, client_batches, **kw)

    with mock.patch.object(jgd, "run_distributed_fedgkt_loopback", recording):
        want = jmain_gkt.main(["--backend", "loopback"])
    start = tuple(_port_vars(v, torch.float32) for v in seen["init"])
    with mock.patch.object(fedgkt.FedGKT, "init", lambda self, g: start):
        got = _within_deadline(lambda: main_fedgkt.run(_gkt_args(["--backend", "loopback"])),
                               [])
        inprocess = main_fedgkt.run(_gkt_args())
    assert got == want == inprocess
