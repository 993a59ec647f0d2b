"""The port's augmentation (fedml_tpu_torch/ops/augment.py) against the JAX
package's ops (fedml_tpu/ops/augment.py).

JAX draws its offsets from threefry keys, which torch cannot reproduce, so
each op is held to the JAX op's formula evaluated in JAX at the offsets the
port drew: ``jax.lax.dynamic_slice`` of the zero-padded image for the crop,
``img[:, ::-1, :]`` for the flip and the JAX cutout's window mask.

Tolerance: none. The ops move and zero values, they compute none, so the
port is held bitwise equal to the formula; the same generator seed gives
bitwise the same batches in both cohort modes."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch.core.trainer import ClientTrainer, sgd
from fedml_tpu_torch.ops.augment import ImageAugment, round_generator
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig


def _jax_formula(img, d, padding, length, flip):
    """One [H, W, C] image through the JAX ops' formulas at draws ``d``."""
    img = jnp.asarray(img)
    padded = jnp.pad(img, ((padding, padding), (padding, padding), (0, 0)), mode="constant")
    img = jax.lax.dynamic_slice(padded, (int(d["dy"]), int(d["dx"]), 0), img.shape)
    if flip:
        img = jnp.where(bool(d["flip"]), img[:, ::-1, :], img)
    if length:
        h, w, _ = img.shape
        ys, xs = jnp.arange(h)[:, None], jnp.arange(w)[None, :]
        cy, cx = int(d["cy"]), int(d["cx"])
        mask = ((ys >= cy - length // 2) & (ys < cy + length // 2)
                & (xs >= cx - length // 2) & (xs < cx + length // 2))
        img = img * (1.0 - mask.astype(img.dtype))[..., None]
    return np.asarray(img)


@pytest.mark.parametrize("padding,length,flip", [(4, 16, True), (4, 0, False), (2, 6, True)])
def test_ops_match_jax_formula_at_the_drawn_offsets(rng, padding, length, flip):
    aug = ImageAugment(padding=padding, cutout_length=length, flip=flip)
    x = rng.randn(3, 5, 32, 32, 3).astype(np.float32)
    draws = aug.draw(round_generator(0, 1, 2), (3, 5), (32, 32))
    assert {k: v.shape for k, v in draws.items()} == {k: (3, 5) for k in
                                                      ("dy", "dx", "flip", "cy", "cx")}
    assert int(draws["dy"].max()) <= 2 * padding and int(draws["cy"].max()) < 32
    out = aug.apply(torch.tensor(x), draws).numpy()
    for i in range(3):
        for j in range(5):
            d = {k: v[i, j] for k, v in draws.items()}
            np.testing.assert_array_equal(out[i, j], _jax_formula(x[i, j], d, padding, length,
                                                                  flip))


def test_cutout_window_is_exact_and_clipped_at_the_edges():
    aug = ImageAugment(padding=0, cutout_length=16, flip=False)
    x = torch.ones(4, 32, 32, 3)
    centres = [(16, 16), (0, 0), (31, 5), (3, 31)]
    draws = {"dy": torch.zeros(4, dtype=torch.long), "dx": torch.zeros(4, dtype=torch.long),
             "flip": torch.zeros(4, dtype=torch.long),
             "cy": torch.tensor([c[0] for c in centres]),
             "cx": torch.tensor([c[1] for c in centres])}
    out = aug.apply(x, draws)
    for i, (cy, cx) in enumerate(centres):
        rows = min(cy + 8, 32) - max(cy - 8, 0)
        cols = min(cx + 8, 32) - max(cx - 8, 0)
        zeros = out[i, :, :, 0] == 0
        assert int(zeros.sum()) == rows * cols
        assert bool(zeros[max(cy - 8, 0):cy + 8, max(cx - 8, 0):cx + 8].all())
    assert int((out[0, :, :, 0] == 0).sum()) == 16 * 16
    # crop 0 offset with zero padding shifts the image: its top-left corner
    # comes from the padding
    shifted = ImageAugment(padding=4, cutout_length=0, flip=False).apply(
        x, {**draws, "dy": torch.zeros(4, dtype=torch.long)})
    assert float(shifted[0, 0, 0, 0]) == 0.0 and float(shifted[0, 4, 4, 0]) == 1.0


def test_draws_depend_on_seed_round_and_slot():
    aug = ImageAugment()
    a = aug.draw(round_generator(0, 1, 2), (2, 3, 8), (32, 32))
    b = aug.draw(round_generator(0, 1, 2), (2, 3, 8), (32, 32))
    assert all(torch.equal(a[k], b[k]) for k in a)
    for other in ((1, 1, 2), (0, 2, 2), (0, 1, 3)):
        c = aug.draw(round_generator(*other), (2, 3, 8), (32, 32))
        assert not all(torch.equal(a[k], c[k]) for k in a)
    with pytest.raises(ValueError, match="images"):
        aug.apply(torch.zeros(4, 32, 32), {k: v[0, 0, :4] for k, v in a.items()})


class _Recorder(torch.nn.Module):
    """A linear classifier that records every batch it sees."""

    def __init__(self, seen):
        super().__init__()
        self.fc = torch.nn.Linear(4 * 4 * 3, 3)
        self.seen = seen

    def reset_parameters(self, generator=None):
        torch.nn.init.normal_(self.fc.weight, std=0.1, generator=generator)
        torch.nn.init.zeros_(self.fc.bias)

    def forward(self, x):
        self.seen.append(x.clone())
        return self.fc(x.reshape(*x.shape[:-3], -1))


def test_scan_and_vmap_see_the_same_augmented_batches_and_eval_none():
    """The round's draws (seeded from seed, round, client slot) give bitwise
    the same augmented batches whether applied to the cohort's [C, B, ...]
    step (vmap) or to each client's [B, ...] batch (scan); the scan run
    trains on exactly those, and evaluation sees the raw images."""
    rng = np.random.RandomState(0)
    x = rng.randn(30, 4, 4, 3).astype(np.float32)
    y = rng.randint(0, 3, 30).astype(np.int32)
    part = {0: np.arange(0, 9), 1: np.arange(9, 13), 2: np.arange(13, 24)}
    seen = []
    aug = ImageAugment(padding=1, cutout_length=2)
    trainer = ClientTrainer(module=_Recorder(seen), optimizer=sgd(0.1), epochs=2, augment=aug)
    sim = FedSim(trainer, FederatedArrays({"x": x[:24], "y": y[:24]}, part),
                 {"x": x[24:], "y": y[24:]},
                 SimConfig(client_num_in_total=3, client_num_per_round=3, batch_size=4,
                           comm_round=1, epochs=2, eval_batch_size=6, cohort_execution="scan",
                           shuffle_each_round=False),
                 device="cpu")
    draws = sim._round_draws(0, 3)
    assert {k: tuple(v.shape) for k, v in draws.items()} == {
        k: (3, 2, 3, 4) for k in ("dy", "dx", "flip", "cy", "cx")}
    idx, _, _ = sim._host_cohort_indices(np.arange(3), 0)
    data = sim._gather_batches(sim._dataset, torch.as_tensor(idx))
    expected = []
    for e in range(2):
        for s in range(3):
            step = {k: d[:, e, s] for k, d in draws.items()}
            cohort = aug.apply(data["x"][:, s], step)  # the vmap mode's call
            clients = [aug.apply(data["x"][c, s], {k: d[c] for k, d in step.items()})
                       for c in range(3)]  # the scan mode's
            assert torch.equal(cohort, torch.stack(clients))
            expected.append(cohort)
    sim.run_round(0, sim.init_variables())
    # scan trains client by client on its batches that hold data, in order
    order = [(c, e, s) for c in range(3) for e in range(2) for s in range(3)
             if data["mask"][c, s].sum() > 0]
    assert len(seen) == len(order)
    for t, (c, e, s) in zip(seen, order):
        assert torch.equal(t, expected[e * 3 + s][c])
    seen.clear()
    sim.evaluate(sim.init_variables())
    test_batches = [t for t in seen if t.shape[0] == 6 and torch.equal(t, torch.tensor(x[24:]))]
    assert len(test_batches) == 1
