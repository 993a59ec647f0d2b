"""The port's deployment artifact (``models/export.py``: ``export_program``,
``load_program``, ``Functional``) against the JAX package's StableHLO one
(``export_stablehlo``/``load_stablehlo``, ``tests/test_obs_export.py``).

Tolerances: the round trip bitwise on the CPU (the loaded program runs the
traced aten ops on the same inputs); the loaded program's output against
JAX's loaded StableHLO output on the same LogisticRegression variables
rtol 1e-6 (the JAX test's own bound between its loaded and eager
outputs)."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fedml_tpu.models.export import export_stablehlo, load_stablehlo
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch import convert
from fedml_tpu_torch.models.export import Functional, export_program, load_program
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.resnet import CifarResNet


def _lr_pair():
    model = JaxLR(num_classes=3)
    v = model.init(jax.random.key(0), jnp.ones((2, 8)))
    port = LogisticRegression(num_classes=3, in_features=8, device="cpu")
    v = jax.tree.map(np.asarray, v)
    return model, v, port, convert.from_flax(v)


def test_round_trip_is_bitwise_and_returns_the_file(tmp_path):
    _, _, port, sd = _lr_pair()
    x = torch.tensor(np.random.RandomState(0).randn(5, 8).astype(np.float32))
    blob = export_program(Functional(port), (sd, x), tmp_path / "lr.pt2")
    assert blob == (tmp_path / "lr.pt2").read_bytes() and len(blob) > 0
    loaded = load_program(tmp_path / "lr.pt2")
    assert torch.equal(loaded.call(sd, x), Functional(port)(sd, x))
    # the variables are an input: other values, the same program
    other = {k: v + 0.5 for k, v in sd.items()}
    assert torch.equal(loaded.call(other, x), Functional(port)(other, x))


def test_a_callable_exports_too(tmp_path):
    _, _, port, sd = _lr_pair()
    x = torch.ones(2, 8)

    def fwd(variables, xin):
        return torch.softmax(torch.func.functional_call(port, variables, (xin,)), -1)

    export_program(fwd, (sd, x), tmp_path / "fn.pt2")
    assert torch.equal(load_program(tmp_path / "fn.pt2").call(sd, x), fwd(sd, x))


def test_loaded_program_matches_jax_stablehlo(tmp_path):
    """The JAX test's LogisticRegression and input, through both
    packages' artifacts."""
    model, v, port, sd = _lr_pair()
    x = np.ones((2, 8), np.float32)

    def fwd(variables, xin):
        return model.apply(variables, xin)

    export_stablehlo(fwd, (v, jnp.asarray(x)), tmp_path / "model.stablehlo")
    want = np.asarray(load_stablehlo(tmp_path / "model.stablehlo").call(v, jnp.asarray(x)))
    export_program(Functional(port), (sd, torch.tensor(x)), tmp_path / "model.pt2")
    got = load_program(tmp_path / "model.pt2").call(sd, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # and on an input the JAX program was not traced on
    x2 = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    want2 = np.asarray(load_stablehlo(tmp_path / "model.stablehlo").call(v, jnp.asarray(x2)))
    got2 = load_program(tmp_path / "model.pt2").call(sd, torch.tensor(x2)).numpy()
    np.testing.assert_allclose(got2, want2, rtol=1e-6)


def test_resnet_eval_forward_round_trip(tmp_path):
    """A BatchNorm ResNet's evaluation forward (depth 8: the flagship's
    blocks), the running statistics among the variables."""
    net = CifarResNet(depth=8, num_classes=10, device="cpu")
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    sd = {k: v + 0.01 * torch.arange(v.numel(), dtype=v.dtype).reshape(v.shape) / v.numel()
          for k, v in sd.items()}
    x = torch.tensor(np.random.RandomState(2).rand(3, 32, 32, 3).astype(np.float32))
    fn = Functional(net)
    export_program(fn, (sd, x), tmp_path / "resnet.pt2")
    assert torch.equal(load_program(tmp_path / "resnet.pt2").call(sd, x), fn(sd, x))
