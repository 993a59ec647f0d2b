"""Positional fields of the dataclasses both packages define.

For every dataclass that ``fedml_tpu_torch.<path>`` and ``fedml_tpu.<path>``
both define under the same name, the JAX fields must be a prefix of the
port's, in the same order and with the same defaults, so that one
positional call means the same thing in both packages; the port's own
fields come after them. One case per pair.

One field is replaced rather than kept: the JAX ``PackedStaged.rkey`` holds
the round's PRNG key, which the port has no use for (its randomness is
drawn from the seed and the round); its place holds the round's
augmentation draws, ``draws``. Every other name, position and default is
compared as it is.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import dataclasses
import importlib
import inspect
import pkgutil

import pytest

import fedml_tpu_torch

# (module under the package, class) -> {JAX field: the port's field in its place}
_REPLACED = {("sim.engine", "PackedStaged"): {"rkey": "draws"}}


def _shared_dataclasses():
    pairs = []
    for info in pkgutil.walk_packages(fedml_tpu_torch.__path__, "fedml_tpu_torch."):
        port = importlib.import_module(info.name)
        rel = info.name.split(".", 1)[1]
        try:
            ref = importlib.import_module(f"fedml_tpu.{rel}")
        except ImportError:
            continue
        for name, obj in sorted(vars(port).items()):
            other = getattr(ref, name, None)
            if (inspect.isclass(obj) and dataclasses.is_dataclass(obj)
                    and obj.__module__ == info.name
                    and inspect.isclass(other) and dataclasses.is_dataclass(other)):
                pairs.append(pytest.param(rel, name, obj, other, id=f"{rel}.{name}"))
    return pairs


_PAIRS = _shared_dataclasses()


def _default(field):
    """A field's default, comparable across packages: a value by its repr
    (a default that is itself one of the package's dataclasses, such as
    ``PopulationSpec.speed``, is another class in each package)."""
    if field.default is not dataclasses.MISSING:
        return ("value", repr(field.default))
    if field.default_factory is not dataclasses.MISSING:
        return ("factory",)
    return ("required",)


def test_the_shared_dataclasses_are_found():
    found = {(p.values[0], p.values[1]) for p in _PAIRS}
    assert {("sim.engine", "SimConfig"), ("core.trainer", "ClientTrainer"),
            ("algorithms.base", "Aggregator"), ("algorithms.robust", "RobustConfig"),
            ("population.model", "PopulationSpec"), ("sim.engine", "PackedStaged")} <= found


@pytest.mark.parametrize("rel, name, port, ref", _PAIRS)
def test_jax_fields_are_a_prefix_of_the_port_fields(rel, name, port, ref):
    replaced = _REPLACED.get((rel, name), {})
    jax_fields = dataclasses.fields(ref)
    port_fields = dataclasses.fields(port)
    assert len(port_fields) >= len(jax_fields)
    for j, p in zip(jax_fields, port_fields):
        assert p.name == replaced.get(j.name, j.name), (
            [f.name for f in jax_fields], [f.name for f in port_fields])
        if j.name not in replaced:
            assert _default(p) == _default(j), (j.name, _default(j), _default(p))


def test_a_per_client_aggregator_is_refused():
    """The JAX per-client fields exist on the port's Aggregator and select
    the engine's per-client mode, which refuses a rule configured for
    another client count, as the JAX engine does."""
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.base import Aggregator
    from fedml_tpu_torch.core.trainer import ClientTrainer
    from fedml_tpu_torch.models.linear import LogisticRegression
    from fedml_tpu_torch.sim.cohort import FederatedArrays
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    rng = np.random.RandomState(0)
    x, y = rng.randn(8, 4).astype(np.float32), rng.randint(0, 3, 8).astype(np.int32)
    agg = Aggregator(lambda v: (), lambda *a: None, "gossip", True, 3)
    with pytest.raises(ValueError, match="configured for 3 clients"):
        FedSim(ClientTrainer(module=LogisticRegression(3, 4, device="cpu")),
               FederatedArrays({"x": x, "y": y}, {0: np.arange(4), 1: np.arange(4, 8)}),
               {"x": x, "y": y}, SimConfig(client_num_in_total=2, client_num_per_round=2),
               aggregator=agg, device=torch.device("cpu"))
