"""The port's vmap cohort mode (``cohort_execution="vmap"``): the functional
optimizer, ``make_vmap_train``, ``FedSim``'s vmap round and the flash
attention's vmap rule, against optax, the port's own scan mode and the JAX
engine's vmap mode, on the same numpy-made inputs.

Tolerances, fixed before the first run:
- functional SGD and ``torch.optim.SGD`` against
  ``optax.chain(add_decayed_weights, sgd)``: atol 1e-6 (the same f32
  products and sums, a fused multiply-add apart);
- port vmap against port scan: atol 1e-5 on parameters, BN statistics,
  losses and eval metrics. The same arithmetic per client, with batched
  (grouped) convolutions and products summed in other orders;
- two FedAvg rounds of the port in vmap against the JAX ``FedSim`` in vmap,
  depth-8 ResNet, ragged hetero clients, no stragglers, no augmentation:
  atol 1e-4 on parameters, BN statistics, losses and eval metrics. Two
  rounds of 2 epochs of SGD with momentum through eight conv/BN layers,
  f32 in both, with the weighted fold summed in another order;
- the tiny TransformerLM with ``attn_impl="flash"`` in vmap against scan on
  the CPU (the plain version under the vmap rule, the blockwise backward
  under vmap): atol 1e-5."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core import rng as jrng
from fedml_tpu.core import tree as jtree
from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
from fedml_tpu.models.resnet import CifarResNet as JaxResNet
from fedml_tpu.sim import cohort as jcohort
from fedml_tpu.sim.engine import FedSim as JaxSim
from fedml_tpu.sim.engine import SimConfig as JaxConfig
from fedml_tpu_torch import convert
from fedml_tpu_torch.core import tree as ttree
from fedml_tpu_torch.core.trainer import ClientTrainer, make_vmap_train, sgd
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.ops import attention
from fedml_tpu_torch.ops.augment import ImageAugment
from fedml_tpu_torch.sim.cohort import FederatedArrays
from fedml_tpu_torch.sim.engine import FedSim, SimConfig

ATOL = 1e-5
JAX_ATOL = 1e-4


# -- the optimizer -----------------------------------------------------------


@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.0, 1e-3), (0.9, 0.01)])
def test_sgd_forms_match_optax(rng, momentum, wd):
    """Five steps of the functional form (on a [C, ...] stack, as the vmap
    mode steps it) and of torch.optim.SGD against optax, step for step."""
    p0 = rng.randn(3, 6, 4).astype(np.float32)
    grads = [rng.randn(3, 6, 4).astype(np.float32) for _ in range(5)]
    lr = 0.05
    opt = optax.chain(optax.add_decayed_weights(wd), optax.sgd(lr, momentum))
    p_j, state_j = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tsgd = sgd(lr, momentum, wd)
    p_f, state_f = {"w": torch.tensor(p0)}, tsgd.init({"w": torch.tensor(p0)})
    p_t = torch.nn.Parameter(torch.tensor(p0))
    topt = tsgd([p_t])
    for g in grads:
        updates, state_j = opt.update(jnp.asarray(g), state_j, p_j)
        p_j = optax.apply_updates(p_j, updates)
        p_f, state_f = tsgd.update({"w": torch.tensor(g)}, state_f, p_f)
        p_t.grad = torch.tensor(g)
        topt.step()
        np.testing.assert_allclose(p_f["w"].numpy(), np.asarray(p_j), atol=1e-6)
        np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), atol=1e-6)
    # per-client steps of the stack are the steps of each client alone
    one, _ = tsgd.update({"w": torch.tensor(grads[0][1])}, tsgd.init({"w": torch.tensor(p0[1])}),
                         {"w": torch.tensor(p0[1])})
    both, _ = tsgd.update({"w": torch.tensor(grads[0])}, tsgd.init({"w": torch.tensor(p0)}),
                          {"w": torch.tensor(p0)})
    assert torch.equal(both["w"][1], one["w"])


def test_stacked_tree_ops_match_jax(rng):
    """tree_weighted_mean over a leading client axis (weights normalised in
    f32, leaves summed in f32 and cast back; BN statistics like weights),
    tree_stack and tree_unstack."""
    trees = [{"w": rng.randn(3, 4).astype(np.float32),
              "bn.running_var": rng.rand(5).astype(np.float32),
              "h": rng.randn(2).astype(np.float32).astype(jnp.bfloat16)} for _ in range(4)]
    weights = np.array([3.0, 0.0, 5.0, 1.5], np.float32)
    j_stacked = jtree.tree_stack([{k: jnp.asarray(v) for k, v in t.items()} for t in trees])
    t_trees = [{k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.bfloat16 if k == "h" else torch.float32) for k, v in t.items()} for t in trees]
    t_stacked = ttree.stack(t_trees)
    for k in trees[0]:
        np.testing.assert_array_equal(t_stacked[k].float().numpy(),
                                      np.asarray(j_stacked[k], np.float32))
    j_mean = jtree.tree_weighted_mean(j_stacked, jnp.asarray(weights))
    t_mean = ttree.stacked_weighted_mean(t_stacked, torch.tensor(weights))
    for k in trees[0]:
        assert t_mean[k].dtype == t_stacked[k].dtype
        np.testing.assert_allclose(t_mean[k].float().numpy(), np.asarray(j_mean[k], np.float32),
                                   atol=1e-6, err_msg=k)
    # the sequential fold over the unstacked views agrees too
    seq = ttree.weighted_mean(iter(ttree.unstack(t_stacked, 4)), torch.tensor(weights))
    for k in ("w", "bn.running_var"):
        np.testing.assert_allclose(seq[k].numpy(), np.asarray(j_mean[k]), atol=1e-6)
    views = ttree.unstack(t_stacked, 4)
    assert len(views) == 4 and all(torch.equal(views[2][k], t_trees[2][k]) for k in trees[0])
    assert views[1]["w"].data_ptr() == t_stacked["w"][1].data_ptr()  # views, not copies


# -- data and models ---------------------------------------------------------


def _image_data(rng, size=8):
    """Five ragged clients (3 to 11 samples) of 8x8 images and a test set."""
    sizes = [11, 3, 7, 9, 5]
    n = sum(sizes)
    x = rng.randn(n + 10, size, size, 3).astype(np.float32)
    y = rng.randint(0, 10, n + 10).astype(np.int32)
    starts = np.cumsum([0] + sizes)
    part = {c: np.arange(starts[c], starts[c + 1]) for c in range(len(sizes))}
    return {"x": x[:n], "y": y[:n]}, part, {"x": x[n:], "y": y[n:]}


def _resnet_sim(mode, arrays, part, test, init, augment=None, epochs=2, **kw):
    model = CifarResNet(depth=8, num_classes=10, device="cpu")
    trainer = ClientTrainer(module=model, optimizer=sgd(0.05, 0.9, 1e-3), epochs=epochs,
                            augment=augment)
    cfg = SimConfig(client_num_in_total=5, client_num_per_round=4, batch_size=4, comm_round=2,
                    epochs=epochs, frequency_of_the_test=1, eval_batch_size=8, seed=3,
                    cohort_execution=mode, **kw)
    sim = FedSim(trainer, FederatedArrays(arrays, part), test, cfg, device="cpu")
    return sim, {k: v.clone() for k, v in (init or sim.init_variables()).items()}


def _two_rounds(sim, variables):
    out = []
    for r in range(2):
        variables, _, m = sim.run_round(r, variables)
        out.append((dict(variables), float(m["Train/Loss"]), sim.evaluate(variables)))
    return out


def _assert_rounds_close(a, b, atol):
    for (va, la, ea), (vb, lb, eb) in zip(a, b):
        assert list(va) == list(vb)
        for k in va:
            np.testing.assert_allclose(va[k].numpy(), vb[k].numpy(), atol=atol, err_msg=k)
        np.testing.assert_allclose(la, lb, atol=atol)
        assert set(ea) == set(eb)
        for k in ea:
            np.testing.assert_allclose(ea[k], eb[k], atol=atol, err_msg=k)


# -- port vmap against port scan ---------------------------------------------


def test_simconfig_defaults_to_vmap():
    assert SimConfig().cohort_execution == "vmap"
    with pytest.raises(ValueError, match="cohort_execution"):
        SimConfig(cohort_execution="pmap")


def test_resnet_vmap_matches_scan_with_augmentation(rng):
    """Two rounds of the depth-8 ResNet with BN, weight decay, momentum and
    augmentation: the same round draws reach both modes."""
    arrays, part, test = _image_data(rng)
    aug = ImageAugment(padding=2, cutout_length=4)
    vsim, init = _resnet_sim("vmap", arrays, part, test, None, augment=aug)
    ssim, _ = _resnet_sim("scan", arrays, part, test, init, augment=aug)
    _assert_rounds_close(_two_rounds(vsim, init), _two_rounds(ssim, init), ATOL)


def test_vmap_train_guards_padded_and_over_budget_steps(rng):
    """A client whose budget ends after one step, and one with no data at
    all, keep their variables (model state included) past that point."""
    arrays, part, _ = _image_data(rng)
    model = CifarResNet(depth=8, num_classes=10, device="cpu")
    trainer = ClientTrainer(module=model, optimizer=sgd(0.05, 0.9, 1e-3), epochs=2)
    g = {k: v.detach().clone() for k, v in model.state_dict().items()}
    idx = np.full((3, 2, 4), -1, np.int32)
    idx[0] = np.arange(8).reshape(2, 4)
    idx[1, 0, :2] = [8, 9]
    data = FedSim._gather_batches({k: torch.tensor(v) for k, v in arrays.items()},
                                  torch.tensor(idx))
    stacked, m = make_vmap_train(trainer)(g, data, torch.tensor([4, 1, 4]))
    assert all(torch.equal(stacked[k][2], g[k]) for k in g)  # no data: untouched
    assert float(m["train_loss"][2]) == 0.0
    # client 1: its one executed step equals that step alone
    alone, m1 = make_vmap_train(trainer)(g, {k: v[1:2] for k, v in data.items()},
                                         torch.tensor([1]))
    for k in g:
        np.testing.assert_allclose(stacked[k][1].numpy(), alone[k][0].numpy(), atol=ATOL)
        assert not torch.equal(alone[k][0], g[k]) or k.endswith("num_batches_tracked")
    np.testing.assert_allclose(float(m["train_loss"][1]), float(m1["train_loss"][0]), atol=ATOL)


def test_vmap_refuses_what_it_cannot_run(rng):
    """No fallback: an optimizer without a functional form, or a module that
    writes its buffers in place, raises instead of training in scan."""
    model = CifarResNet(depth=8, device="cpu")
    with pytest.raises(TypeError, match="functional form"):
        make_vmap_train(ClientTrainer(module=model, optimizer=lambda ps: torch.optim.SGD(ps, 0.1)))

    class TorchBN(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = torch.nn.BatchNorm2d(3)
            self.fc = torch.nn.Linear(3, 10)

        def forward(self, x, train=False):
            out = self.fc(self.bn(x.permute(0, 3, 1, 2)).mean((2, 3)))
            return (out, {}) if train else out

    arrays, part, test = _image_data(rng)
    trainer = ClientTrainer(module=TorchBN().train())
    sim = FedSim(trainer, FederatedArrays(arrays, part), test,
                 SimConfig(client_num_in_total=5, client_num_per_round=2, batch_size=4),
                 device="cpu")
    variables = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    with pytest.raises(RuntimeError):
        sim.run_round(0, variables)


# -- port vmap against the JAX engine's vmap ----------------------------------


def test_resnet_fedavg_vmap_matches_jax_vmap(rng):
    arrays, part, test = _image_data(rng)
    kw = dict(client_num_in_total=5, client_num_per_round=4, batch_size=4, comm_round=2,
              epochs=2, frequency_of_the_test=1, eval_batch_size=8, seed=3)
    jtrainer = JaxTrainer(module=JaxResNet(depth=8, num_classes=10),
                          optimizer=optax.chain(optax.add_decayed_weights(1e-3),
                                                optax.sgd(0.05, 0.9)), epochs=2)
    jsim = JaxSim(jtrainer, jcohort.FederatedArrays(arrays, part), test,
                  JaxConfig(cohort_execution="vmap", **kw))
    j_vars = jsim.init_round_variables()
    j_state = jsim.aggregator.init_state(j_vars)
    init = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    tsim, t_vars = _resnet_sim("vmap", arrays, part, test, init)
    assert tsim.config.cohort_execution == "vmap"
    root = jrng.root_key(kw["seed"])
    for r in range(2):
        j_vars, j_state, j_m = jsim.run_round(r, j_vars, j_state, root)
        t_vars, _, t_m = tsim.run_round(r, t_vars)
        j_sd = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
        assert set(j_sd) == set(t_vars)
        for k in j_sd:  # parameters and BN statistics
            np.testing.assert_allclose(t_vars[k].numpy(), j_sd[k].numpy(), atol=JAX_ATOL,
                                       err_msg=k)
        np.testing.assert_allclose(float(t_m["Train/Loss"]), float(j_m["Train/Loss"]),
                                   atol=JAX_ATOL)
        j_eval, t_eval = jsim.evaluate(j_vars), tsim.evaluate(t_vars)
        assert set(t_eval) == set(j_eval)
        for k in j_eval:
            np.testing.assert_allclose(t_eval[k], j_eval[k], atol=JAX_ATOL, err_msg=k)


# -- the TransformerLM and the flash vmap rule --------------------------------

VOCAB, T, L = 23, 16, 2


def _lm_sim(mode, attn_impl, init=None):
    rng = np.random.RandomState(0)
    n = 30
    x = rng.randint(0, VOCAB, (n + 6, T)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    mask = np.ones((n + 6, T), np.float32)
    mask[::3, 12:] = 0.0
    part = {c: np.arange(c * 10, c * 10 + 10 - 3 * c) for c in range(3)}
    model = TransformerLM(vocab_size=VOCAB, embed_dim=16, num_layers=L, num_heads=2, max_len=T,
                          attn_impl=attn_impl, block_q=8, block_k=8, device="cpu")
    cfg = SimConfig(client_num_in_total=3, client_num_per_round=3, batch_size=4, comm_round=2,
                    epochs=2, eval_batch_size=6, train_eval_samples=12, seed=1,
                    cohort_execution=mode)
    sim = FedSim(ClientTrainer(module=model, task="nwp", optimizer=sgd(0.1, 0.9), epochs=2),
                 FederatedArrays({"x": x[:n], "y": y[:n], "mask": mask[:n]}, part),
                 {"x": x[n:], "y": y[n:], "mask": mask[n:]}, cfg, device="cpu")
    return sim, {k: v.clone() for k, v in (init or sim.init_variables()).items()}


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_lm_vmap_matches_scan(attn_impl):
    vsim, init = _lm_sim("vmap", attn_impl)
    ssim, _ = _lm_sim("scan", attn_impl, init)
    _assert_rounds_close(_two_rounds(vsim, init), _two_rounds(ssim, init), ATOL)


def test_flash_forward_runs_once_per_step_under_vmap(monkeypatch):
    """Under vmap every client's step reaches the forward once, folded: one
    call per layer per step with the batch axis C * B (on the card, one
    kernel launch counted in its counter). Scan calls it once per layer per
    executed client step."""
    calls = []
    real = attention._flash_fwd

    def counting(q, *args):
        calls.append(q.shape[0])
        return real(q, *args)

    monkeypatch.setattr(attention, "_flash_fwd", counting)
    counts = {}
    for mode in ("vmap", "scan"):
        calls.clear()
        sim, variables = _lm_sim(mode, "flash")
        sim.run_round(0, variables)
        counts[mode] = list(calls)
    # clients hold 10, 7, 4 samples: S = 3 steps of batch 4, E = 2
    assert counts["vmap"] == [3 * 4] * (L * 2 * 3)
    assert counts["scan"] == [4] * (L * 2 * (3 + 2 + 1))
