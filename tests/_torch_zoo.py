"""The parity harness of the CIFAR zoo tests (``test_torch_resnet18.py``,
``test_torch_mobilenet.py``, ``test_torch_vgg.py``,
``test_torch_efficientnet.py``): one JAX model against its port, from the
same JAX-initialised variables carried across by ``convert.from_flax``.

The variables are drawn with numpy over the tree flax's init makes
(:func:`numpy_variables`; compiling flax's init costs more than the
checks). The JAX side is two jits per model (:func:`jax_reference`): the
f64 evaluations of the port's f32 checks (the
eval logits, the training forward's logits and new ``batch_stats``, one SGD
step with weight decay and momentum through the JAX ``make_local_train``
of the model's federated recipe on a batch whose last row is padding), and
the bf16 eval logits. The f32
checks are held to the JAX functions computed in float64, the exact
functions the f32 code approximates: XLA:CPU's f32 reductions are
sequential, so a BatchNorm over a 4 x 32 x 32 batch is 2.7e-5 to 2.2e-4 off
float64 in the JAX package (1.6e-6 to 1.6e-5 in torch), and MobileNet
V1's 27 BatchNorms in training put the JAX package's f32 logits 9.4e-4
from float64, the port's 1.1e-5. Each step runs at its model's recipe lr.
A dropout's keep mask is read off the JAX training forward's
own output (a kept element is ``x / keep``, a dropped one 0; an element
that is 0 either way is the same under any mask) and handed to the port.

Tolerances: f32 logits, statistics and the step's loss within 1e-4 of
float64 (absolute, the CNN checks' value), the step's variables too, or,
where f32 arithmetic cannot get that close, no farther from float64 than
the JAX package's own f32 step (MobileNet V1: the port 1.4e-4, the JAX
package 6.9e-4; its early layers' gradients are 1-2% off float64 in f32,
the deep plain ReLU + BatchNorm stack's gradient growth); bf16 eval
logits within ``2^-6 + 2^-7 * |x|`` of the JAX bf16 logits, or, where
bf16's rounding through a deep stack parts the two packages further, at
most twice as far from float64 as the JAX package's bf16 logits, the rule
``tests/test_torch_resnet.py`` holds bf16 to (EfficientNet-b0's 49 conv +
GroupNorm layers: on 32 x 32 images the port 0.080, the JAX package 0.132;
on 16 x 16 the port 0.110, the JAX package 0.095; logits up to ~1.5); the
converter round trip bitwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import linen as nn

from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.core.trainer import make_local_train as jax_local_train
from fedml_tpu_torch import convert
from fedml_tpu_torch.core.trainer import ClientTrainer, make_local_train, sgd

ATOL = 1e-4
MOMENTUM = 0.9
# each model's step is its federated recipe's: SGD lr 0.001, weight decay
# 0.001 for the cross-silo zoo (repro_cross_silo.py), lr 0.1 for the
# fed_cifar100 ResNet-18 (repro_fed_cifar100.py)
CROSS_SILO, FED_CIFAR100 = (1e-3, 1e-3), (0.1, 0.0)


def batch(rng, n, size, classes):
    x = rng.randn(n, size, size, 3).astype(np.float32)
    x[-1] = 0.0  # a zero-filled padding row, as the engine's gather makes it
    y = rng.randint(0, classes, n).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    return {"x": x, "y": y, "mask": mask}


def _is_dropout(mdl, method):
    return isinstance(mdl, nn.Dropout)


def numpy_variables(jax_model, data, rng) -> dict:
    """The model's variables drawn with numpy over the tree flax's init
    would make (``jax.eval_shape``, nothing compiled): kernels normal with
    variance 1 / fan-in, biases normal(0, 0.1), norm scales 1 + normal(0,
    0.1), BatchNorm running means normal(0, 0.1) and variances in [0.5,
    1.5], so that evaluation too runs through non-trivial statistics."""
    shapes = jax.eval_shape(jax_model.init, {"params": jax.random.key(0),
                                             "dropout": jax.random.key(1)},
                            jnp.asarray(data["x"][:1]))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("bias", "mean"):
            a = 0.1 * rng.randn(*shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            raise ValueError(f"no draw for leaf {name!r}")
        return a.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def jax_reference(jax_of, data, recipe, rng, dropout=False) -> dict:
    """Everything the JAX side gives, as numpy: the variables
    (:func:`numpy_variables`); under x64, one jit of the f64 evaluations;
    then one jit of the bf16 eval logits. ``jax_of(dtype)`` builds the JAX
    model in a compute dtype; ``recipe`` is the step's ``(lr, weight
    decay)``; ``dropout``: the model has a Dropout, whose masks in the step
    are read off a second training forward."""
    lr, wd = recipe
    jm64 = jax_of(jnp.float64)
    variables = numpy_variables(jax_of(jnp.float32), data, rng)
    trainer = JaxTrainer(module=jm64, optimizer=optax.chain(optax.add_decayed_weights(wd),
                                                            optax.sgd(lr, MOMENTUM)))
    local_train = jax_local_train(trainer)
    state = [k for k in variables if k != "params"]
    forward_key = jax.random.key(1)

    def train_forward(v64, x, key):
        return jm64.apply(v64, x, train=True, rngs={"dropout": key},
                          mutable=state + ["intermediates"], capture_intermediates=_is_dropout)

    def ref(v64, x, stacked):
        logits, new = train_forward(v64, x, forward_key)
        stepped, metrics = local_train(v64, stacked, forward_key)
        out = {"eval": jm64.apply(v64, x), "train": logits, "new": new, "step": stepped,
               "loss": metrics["train_loss"]}
        if dropout:  # the step's masks: make_local_train's first split of its key
            out["step_drops"] = train_forward(v64, x, jax.random.split(forward_key)[1])[1][
                "intermediates"]
        return out

    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        stacked = {k: jnp.asarray(v)[None] for k, v in data.items()}
        stacked["x"] = stacked["x"].astype(jnp.float64)
        out = jax.tree.map(np.asarray, jax.jit(ref)(v64, stacked["x"][0], stacked))
    out["variables"] = variables

    def f32_step():
        f32 = JaxTrainer(module=jax_of(jnp.float32), optimizer=trainer.optimizer)
        got, _ = jax.jit(jax_local_train(f32))(variables, {k: jnp.asarray(v)[None]
                                                           for k, v in data.items()},
                                               forward_key)
        return jax.tree.map(np.asarray, dict(got))

    out["f32_step"] = f32_step
    out["bf16"] = np.asarray(jax.jit(jax_of(jnp.bfloat16).apply)(variables,
                                                                 jnp.asarray(data["x"])))
    return out


def dropout_masks(intermediates: dict) -> dict:
    """The port's keep masks (``dropout_i`` -> bool tensor) from flax's
    captured ``Dropout_i`` outputs."""
    return {f"dropout_{name.rsplit('_', 1)[1]}": torch.tensor(out["__call__"][0] != 0)
            for name, out in intermediates.items()}


class _FixedDropout:
    """A stand-in for the round's DropoutStream: one step's masks."""

    def __init__(self, masks):
        self._masks = {k: m[None] for k, m in masks.items()}

    def masks(self, step):
        return self._masks


def check_parity(ref: dict, port32, port16, data, recipe) -> None:
    """Hold the port (f32 and bf16 modules) to ``ref`` (:func:`jax_reference`
    with the same ``recipe``)."""
    variables = ref["variables"]
    port32.load_state_dict(convert.from_flax(variables))
    port16.load_state_dict(convert.from_flax(variables))
    x = torch.tensor(data["x"])
    port32.eval()
    np.testing.assert_allclose(port32(x).detach().numpy(), ref["eval"], atol=ATOL)

    # the training forward and its new statistics
    stateful = next(port32.buffers(), None) is not None
    new = dict(ref["new"])
    drops = dropout_masks(new.pop("intermediates", {}))
    kwargs = {"dropout": drops} if drops else {}
    out = port32(x, train=True, **kwargs)
    logits, stats = out if stateful else (out, {})
    np.testing.assert_allclose(logits.detach().numpy(), ref["train"], atol=ATOL)
    want = convert.from_flax(new) if new else {}
    assert set(stats) == set(want) == {k for k, _ in port32.named_buffers()}
    for k in want:
        np.testing.assert_allclose(stats[k].detach().numpy(), want[k].numpy(), atol=ATOL,
                                   err_msg=k)

    # one SGD step of the recipe through make_local_train
    trainer = ClientTrainer(module=port32, optimizer=sgd(recipe[0], MOMENTUM, recipe[1]))
    stream = _FixedDropout(dropout_masks(ref["step_drops"])) if drops else None
    start = {k: v.clone() for k, v in port32.state_dict().items()}
    stepped, metrics = make_local_train(trainer)(
        start, {k: torch.tensor(v)[None] for k, v in data.items()}, dropout=stream)
    np.testing.assert_allclose(float(metrics["train_loss"]), float(ref["loss"]), atol=ATOL)
    want = convert.from_flax(ref["step"])
    assert set(stepped) == set(want)
    err = max(float((stepped[k].double() - want[k]).abs().max()) for k in want)
    if err > ATOL:  # the f32 arithmetic itself: no farther than the JAX package's f32 step
        jax32 = convert.from_flax(ref["f32_step"]())
        jax_err = max(float((jax32[k].double() - want[k]).abs().max()) for k in want)
        assert err <= jax_err, (err, jax_err)

    # bf16 compute: the logits within 2^-6 + 2^-7 |x| of the JAX package's
    port16.eval()
    got = port16(x).detach().numpy()
    assert got.dtype == ref["bf16"].dtype == np.float32  # the head runs in f32
    bound = 2.0 ** -6 + 2.0 ** -7 * np.abs(ref["bf16"])
    if not np.all(np.abs(got - ref["bf16"]) <= bound):
        # bf16's own rounding through a deep stack: at most twice as far from
        # float64 as the JAX package's bf16 logits (test_torch_resnet.py's rule)
        d_port, d_jax = (np.abs(a - ref["eval"]).max() for a in (got, ref["bf16"]))
        assert d_port <= 2 * d_jax, (d_port, d_jax)

    # the converter round trip, bitwise
    back = convert.to_flax(convert.from_flax(variables))
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def check_shapes(jax_model, port_model, size=32) -> None:
    """The port's state dict has the JAX model's variables, name for name
    and shape for shape, and converts back to their tree."""
    shapes = jax.eval_shape(jax_model.init, {"params": jax.random.key(0),
                                             "dropout": jax.random.key(1)},
                            jnp.zeros((1, size, size, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    assert {k: tuple(v.shape) for k, v in convert.from_flax(zeros).items()} == {
        k: tuple(v.shape) for k, v in port_model.state_dict().items()}
    assert all(p.dtype == torch.float32 for p in port_model.parameters())
    back = convert.to_flax(port_model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(zeros)
