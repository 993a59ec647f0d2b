"""Federated segmentation in the port (the ``segmentation`` task of
``core/trainer.py``, ``models/segmentation.py``, the registry's and the
converter's fedseg arms, ``algorithms/fedseg.py``, ``exp/main_fedseg.py``)
against the JAX package's, on the same numpy-made inputs.

Tolerances:

- ``_gn``, ``_interp_matrix`` and ``_synthetic_seg`` (numpy copies):
  bitwise;
- ``upsample_2d``, nearest and bilinear, up and down, integer and
  non-integer ratios, in float64: atol 1e-12;
- UNet and DeepLabLite at small widths, both packages in float64: the
  forward's logits and one training step's loss and gradients (labels
  holding 255, a padded example) within 1e-6; at full width the registry's
  models have the JAX variables' names and shapes and convert back
  bitwise;
- the task on labels holding 255, f32 logits: the confusion matrix,
  ``test_total`` and ``test_correct`` bitwise, the loss within 1e-6
  (relative); under ``torch.func.vmap`` bitwise the per-client loop;
- the five metric functions on the known matrix of ``tests/test_fedseg.py``
  (and a matrix with an absent class): within 1e-7 of the JAX package's and
  of the closed forms;
- FedSegSim, 4 of 4 clients, 2 rounds of E=1 with Adam, both packages in
  float64 from the same variables, vmap and scan: each round's history
  record and the final variables within 1e-5; ``evaluate_clients``'s
  per-client records and global dict within 1e-5, their confusion
  matrices' counts equal;
- main_fedseg's round of Adam in f32 (UNet and DeepLabLite): no further
  from the float64 round than 4x the JAX package's f32 round (or 1e-4).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import fedseg as jfedseg
from fedml_tpu.core import rng as jrng
from fedml_tpu.core import trainer as jtrainer
from fedml_tpu.exp import main_fedseg as jmain
from fedml_tpu.models import segmentation as jseg
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.algorithms import fedseg
from fedml_tpu_torch.core import trainer
from fedml_tpu_torch.exp import main_fedseg
from fedml_tpu_torch.models import segmentation as seg
from fedml_tpu_torch.models.registry import create_model, to_float64
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import SimConfig
from tests import _torch_zoo as zoo

F64_ATOL = 1e-6
SIM_ATOL = 1e-5


def test_gn_and_interp_matrices_are_copies():
    for groups, c in ((8, 32), (8, 4), (8, 12), (8, 7), (3, 9)):
        assert seg._gn(groups, c) == jseg._gn(groups, c)
    for src, dst in ((3, 6), (2, 5), (5, 10), (8, 3), (32, 128), (7, 7)):
        for method in ("nearest", "bilinear"):
            got = seg._interp_matrix(src, dst, method)
            want = np.asarray(jseg._interp_matrix(src, dst, method))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("src,dst", [((4, 5), (8, 10)), ((2, 3), (10, 7)), ((9, 6), (4, 4))])
def test_upsample_2d_matches_jax(rng, method, src, dst):
    x = rng.randn(2, *src, 3)
    with jax.enable_x64(True):
        want = np.asarray(jseg.upsample_2d(jnp.asarray(x), dst, method))
    interp = seg.Interp()
    got = seg.upsample_2d(torch.tensor(x).permute(0, 3, 1, 2), dst, method, interp)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-12, rtol=0)
    # the matrices are kept, one per (size, method, device, dtype)
    assert len(interp._matrices) == (1 if src[0] == src[1] and dst[0] == dst[1] else 2)


def _seg_batch(rng, n, hw, channels, classes):
    x = rng.randn(n, hw, hw, channels).astype(np.float32)
    y = rng.randint(0, classes, (n, hw, hw)).astype(np.int32)
    y[:, 0, :3] = 255  # ignored pixels
    y[0, -1, -1] = -1
    x[-1] = 0.0  # a zero-filled padding row, as the engine's gather makes it
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    return {"x": x, "y": y, "mask": mask}


_MODELS = {"unet": (jseg.UNet, seg.UNet, (4, 8, 8)),
           "deeplab": (jseg.DeepLabLite, seg.DeepLabLite, (4, 8, 8))}


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_models_forward_and_gradients_match_jax_in_float64(rng, name):
    """A 10 x 10 image: UNet pools to 5 and 2 and upsamples (nearest, a
    non-integer ratio) back through the 2x2 SAME convs; DeepLabLite's
    dilated ConvBlock and ASPP run at 2 x 2, its bilinear upsampling 2 ->
    10."""
    jax_cls, port_cls, features = _MODELS[name]
    classes = 5
    data = _seg_batch(rng, 3, 10, 2, classes)
    jm = jax_cls(num_classes=classes, features=features)
    variables = zoo.numpy_variables(jm, data, rng)

    def loss(params, x):
        return jtrainer.segmentation_loss(jm.apply({"params": params}, x), batch)

    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        batch = {k: jnp.asarray(v) for k, v in data.items()}
        x64 = jnp.asarray(data["x"], jnp.float64)
        logits = np.asarray(jm.apply(v64, x64))
        want_loss, grads = jax.value_and_grad(loss)(v64["params"], x64)
        want_grads = convert.from_flax({"params": jax.tree.map(np.asarray, grads)})

    pm = port_cls(num_classes=classes, features=features, in_channels=2, dtype=torch.float64,
                  device="cpu").double()
    pm.load_state_dict({k: v.double() for k, v in convert.from_flax(variables).items()})
    x = torch.tensor(data["x"])
    out = pm(x)
    assert out.shape == (3, 10, 10, classes) and out.dtype == torch.float64
    np.testing.assert_allclose(out.detach().numpy(), logits, atol=F64_ATOL, rtol=0)
    got_loss = trainer.segmentation_loss(out, {k: torch.tensor(v) for k, v in data.items()})
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), atol=F64_ATOL, rtol=0)
    params = dict(pm.named_parameters())
    assert set(params) == set(want_grads)
    for k, g in want_grads.items():
        np.testing.assert_allclose(params[k].grad.numpy(), g.numpy(), atol=F64_ATOL, rtol=0,
                                   err_msg=k)
    assert list(pm.buffers()) == []


@pytest.mark.parametrize("name", ["unet", "deeplab", "deeplab_lite"])
def test_registry_builds_the_full_width_models(name):
    zoo.check_shapes(jax_create_model(name, 21), create_model(name, 21, device="cpu"))
    # one input channel: the first conv takes it
    model = create_model(name, 3, device="cpu", input_shape=(16, 16, 1))
    assert model.convblocks[0].conv_0.weight.shape[1] == 1
    # as in the JAX registry, the segmentation models take no compute dtype
    with pytest.raises(ValueError, match="does not take a compute dtype"):
        jax_create_model(name, 21, dtype="bfloat16")
    with pytest.raises(ValueError, match="does not take a compute dtype"):
        create_model(name, 21, dtype="bfloat16", device="cpu")


def _ignore_label_batch(pixel_mask=False):
    C = 3
    logits = np.random.RandomState(0).randn(2, 4, 5, C).astype(np.float32)
    y = np.random.RandomState(1).randint(0, C, (2, 4, 5)).astype(np.int32)
    y[0, 0] = [0, 1, 2, 255, 255]
    y[1, 2, 1:3] = 255
    y[1, 3, 0] = 7
    mask = np.array([1.0, 1.0], np.float32)
    if pixel_mask:
        mask = np.ones((2, 4, 5), np.float32)
        mask[1, :, -1] = 0.0
    return logits, {"x": np.zeros((2, 4, 5, 1), np.float32), "y": y, "mask": mask}


@pytest.mark.parametrize("pixel_mask", [False, True])
def test_task_on_ignore_labels_matches_jax(pixel_mask):
    logits, batch = _ignore_label_batch(pixel_mask)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    want = jax.tree.map(np.asarray, jtrainer.segmentation_metrics(jnp.asarray(logits), jb))
    got = {k: v.numpy() for k, v in
           trainer.segmentation_metrics(torch.tensor(logits), tb).items()}
    assert set(got) == set(want)
    for k in ("confusion", "test_total", "test_correct"):
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-6)
    assert np.isfinite(got["test_loss"])
    valid = (batch["y"] >= 0) & (batch["y"] < 3)
    assert got["confusion"].sum() == got["test_total"] <= valid.sum()
    want_loss = float(jtrainer.segmentation_loss(jnp.asarray(logits), jb))
    np.testing.assert_allclose(float(trainer.segmentation_loss(torch.tensor(logits), tb)),
                               want_loss, rtol=1e-6)
    assert trainer.ClientTrainer(module=torch.nn.Identity(), task="segmentation").task


def test_task_metrics_vmap_over_clients_is_the_loop():
    """The engine's per-client evaluation maps the metrics over the cohort:
    bitwise each client's own call."""
    logits, batch = _ignore_label_batch()
    lg = torch.tensor(np.stack([logits, logits[::-1].copy(), -logits]))
    tb = {k: torch.tensor(np.stack([v, v[::-1].copy(), v])) for k, v in batch.items()}
    mapped = torch.func.vmap(trainer.segmentation_metrics)(lg, tb)
    for c in range(3):
        one = trainer.segmentation_metrics(lg[c], {k: v[c] for k, v in tb.items()})
        for k in one:
            assert torch.equal(mapped[k][c], one[k]), (c, k)


def test_unknown_task_raises():
    with pytest.raises(ValueError, match="unknown task"):
        trainer.ClientTrainer(module=torch.nn.Identity(), task="detection")


@pytest.mark.parametrize("conf", [
    [[3.0, 1.0], [2.0, 4.0]],
    [[5.0, 0.0, 2.0], [0.0, 0.0, 0.0], [1.0, 0.0, 7.0]],  # class 1 absent
    [[0.0, 0.0], [0.0, 0.0]],
])
def test_metric_functions_match_jax(conf):
    c = np.asarray(conf, np.float32)
    for fn in ("pixel_accuracy", "pixel_accuracy_class", "iou_per_class", "mean_iou",
               "frequency_weighted_iou"):
        got = getattr(fedseg, fn)(torch.tensor(c)).numpy()
        want = np.asarray(getattr(jfedseg, fn)(jnp.asarray(c)))
        np.testing.assert_allclose(got, want, atol=1e-7, err_msg=fn)
    assert (fedseg.metrics_from_confusion(c, 0.25).__dict__
            == pytest.approx(jfedseg.metrics_from_confusion(c, 0.25).__dict__, abs=1e-7))
    if len(conf) == 2 and c.sum():  # tests/test_fedseg.py's known matrix, closed forms
        keeper = fedseg.metrics_from_confusion(c)
        assert keeper.accuracy == pytest.approx(0.7)
        assert keeper.mIoU == pytest.approx((3 / 6 + 4 / 7) / 2)
        assert keeper.FWIoU == pytest.approx(0.4 * 3 / 6 + 0.6 * 4 / 7)
        assert keeper.accuracy_class == pytest.approx((3 / 4 + 4 / 6) / 2)


@pytest.mark.parametrize("argv", [[], ["--num_classes", "5", "--batch_size", "2", "--seed", "3"],
                                  ["--client_num_in_total", "3"]])
def test_synthetic_seg_is_a_copy(argv):
    jargs = jmain.add_args(argparse.ArgumentParser()).parse_args(argv)
    targs = main_fedseg.add_args(argparse.ArgumentParser()).parse_args(argv)
    (jtrain, jtest), (ttrain, ttest) = jmain._synthetic_seg(jargs), main_fedseg._synthetic_seg(
        targs)
    for k in ("x", "y"):
        assert ttrain.arrays[k].dtype == jtrain.arrays[k].dtype
        np.testing.assert_array_equal(ttrain.arrays[k], jtrain.arrays[k])
        np.testing.assert_array_equal(ttest[k], jtest[k])
    assert sorted(ttrain.partition) == sorted(jtrain.partition)
    for c in jtrain.partition:
        np.testing.assert_array_equal(ttrain.partition[c], jtrain.partition[c])


# ---------------------------------------------------------------------------
# FedSegSim: 2 rounds against the JAX engine, float64
# ---------------------------------------------------------------------------

SIM = dict(client_num_in_total=4, client_num_per_round=4, batch_size=4, comm_round=2,
           epochs=1, frequency_of_the_test=1, seed=0)
FEATURES = (4, 8, 8)


def _sim_data():
    args = jmain.add_args(argparse.ArgumentParser()).parse_args([])
    train, test = jmain._synthetic_seg(args)
    y = train.arrays["y"].copy()
    y[::5, 0, :] = 255  # a band of ignored pixels on every fifth image
    return {"x": train.arrays["x"], "y": y}, train.partition, test


def _f64_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def jax_fedseg():
    arrays, part, test = _sim_data()
    jm = jseg.UNet(num_classes=3, features=FEATURES)
    variables = _f64_tree(zoo.numpy_variables(jm, arrays, np.random.RandomState(4)))
    jt = jtrainer.ClientTrainer(module=jm, task="segmentation", optimizer=optax.adam(3e-3),
                                epochs=1)
    with jax.enable_x64(True):
        jsim = jfedseg.FedSegSim(jt, jcohort.FederatedArrays(arrays, part), test,
                                 JaxConfig(**SIM))
        final, history = jsim.run(variables=jax.tree.map(jnp.asarray, variables))
        per_client, global_m = jsim.evaluate_clients(final)
        confs = np.asarray(jsim.evaluate_per_client(final)["confusion"])
    return variables, _f64_tree(final), history, per_client, global_m, confs


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_fedsegsim_two_rounds_match_jax(jax_fedseg, mode):
    variables, want_final, want_hist, want_clients, want_global, want_confs = jax_fedseg
    arrays, part, test = _sim_data()
    model = seg.UNet(num_classes=3, features=FEATURES, in_channels=1, dtype=torch.float64,
                     device="cpu").double()
    tt = trainer.ClientTrainer(module=model, task="segmentation", optimizer=trainer.adam(3e-3),
                               epochs=1)
    sim = fedseg.FedSegSim(tt, FederatedArrays(arrays, part), test,
                           SimConfig(**SIM, cohort_execution=mode), device="cpu")
    start = {k: v.double() for k, v in convert.from_flax(variables).items()}
    final, history = sim.run(variables=start)
    assert len(history) == len(want_hist) == 2
    for got, want in zip(history, want_hist):
        assert set(got) == set(want)
        for k in want:
            if k != "round_time":
                np.testing.assert_allclose(got[k], want[k], atol=SIM_ATOL, err_msg=k)
    want_vars = convert.from_flax(want_final)
    for k, v in want_vars.items():
        np.testing.assert_allclose(final[k].numpy(), v.numpy(), atol=SIM_ATOL, err_msg=k)

    per_client, global_m = sim.evaluate_clients(final)
    assert set(per_client) == set(want_clients) == {0, 1, 2, 3}
    for c, keeper in want_clients.items():
        assert per_client[c].__dict__ == pytest.approx(keeper.__dict__, abs=SIM_ATOL)
    assert set(global_m) == set(want_global)
    assert global_m == pytest.approx(want_global, abs=SIM_ATOL)
    confs = sim.evaluate_per_client(final)["confusion"]
    assert confs.shape == want_confs.shape == (4, 3, 3)
    np.testing.assert_array_equal(confs, want_confs)


def test_fedsegsim_refuses_another_task():
    arrays, part, test = _sim_data()
    tt = trainer.ClientTrainer(module=seg.UNet(3, FEATURES, 1, device="cpu"))
    with pytest.raises(ValueError, match="segmentation task"):
        fedseg.FedSegSim(tt, FederatedArrays(arrays, part), test, SimConfig(**SIM),
                         device="cpu")


@pytest.mark.parametrize("model", ["unet", "deeplab"])
def test_main_fedseg_runs_on_the_cpu(model):
    out = main_fedseg.main(["--device", "cpu", "--model", model, "--comm_round", "1",
                            "--frequency_of_the_test", "1"])
    for k in ("Train/Loss", "Train/Acc", "Test/Acc", "Test/Loss", "Eval/PixelAcc",
              "Eval/AccClass", "Eval/mIoU", "Eval/FWIoU", "Eval/Loss"):
        assert np.isfinite(out[k]), k
    assert 0.0 <= out["Eval/mIoU"] <= 1.0
    # the global loss is the pooled per-pixel loss over the clients' shards
    assert out["Eval/Loss"] == pytest.approx(out["Train/Loss"], rel=1e-5)


@pytest.fixture(scope="module")
def spread_runs():
    """main_fedseg's defaults, 1 round from the port's seeded variables: the
    logits on the training images after the round, the port's in f32 and
    in float64 (the JAX package's float64 round, held to the port's in
    ``test_fedsegsim_two_rounds_match_jax``) and the JAX package's in
    f32."""
    out = {}
    for model in ("unet", "deeplab"):
        argv = ["--model", model, "--comm_round", "1", "--frequency_of_the_test", "1"]
        targs = main_fedseg.add_args(argparse.ArgumentParser()).parse_args(
            argv + ["--device", "cpu"])
        init = main_fedseg.build(targs).init_variables()
        x = main_fedseg._synthetic_seg(targs)[0].arrays["x"]
        logits = {}
        for name, dtype in (("port32", torch.float32), ("port64", torch.float64)):
            sim = main_fedseg.build(targs)
            if dtype == torch.float64:
                to_float64(sim.trainer.module)
            final, _ = sim.run(variables={k: v.to(dtype) for k, v in init.items()})
            sim.trainer.module.load_state_dict(final)
            with torch.no_grad():
                logits[name] = sim.trainer.module(torch.tensor(x)).double().numpy()
        jargs = jmain.add_args(argparse.ArgumentParser()).parse_args(argv)
        train, test = jmain._synthetic_seg(jargs)
        jm = (jseg.UNet(num_classes=3, features=(8, 8, 16)) if model == "unet"
              else jseg.DeepLabLite(num_classes=3))
        jt = jtrainer.ClientTrainer(module=jm, task="segmentation", optimizer=optax.adam(3e-3),
                                    epochs=1)
        jsim = jfedseg.FedSegSim(jt, train, test, JaxConfig(
            client_num_in_total=4, client_num_per_round=4, batch_size=4, comm_round=1,
            epochs=1, frequency_of_the_test=1, seed=0))
        jfinal, _, _ = jsim.run_round(0, jax.tree.map(jnp.asarray, convert.to_flax(init)), (),
                                      jrng.root_key(0))
        logits["jax32"] = np.asarray(jm.apply(jfinal, jnp.asarray(x)), np.float64)
        out[model] = logits
    return out


@pytest.mark.parametrize("model", ["unet", "deeplab"])
def test_f32_round_spread_is_no_wider_than_the_jax_packages(spread_runs, model):
    """After main_fedseg's round of Adam the f32 logits part from float64 by
    f32's own spread (GroupNorm's fast variance and Adam's normalised steps
    grow the rounding of small gradients), in both packages: the port's
    f32 round is no further from float64 than 4x the JAX package's (or
    1e-4). The figures (printed with ``-s``) are why the card's check holds
    the round in float64."""
    lg = spread_runs[model]
    port, jax_ = (float(np.abs(lg[p] - lg["port64"]).max()) for p in ("port32", "jax32"))
    print(f"[fedseg spread] {model}: f32 round's logits from float64, port {port:.3e}, "
          f"JAX package {jax_:.3e}")
    assert port <= max(1e-4, 4 * jax_)
