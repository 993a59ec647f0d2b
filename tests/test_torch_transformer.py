"""The port's TransformerLM (fedml_tpu_torch/models/transformer.py) against
the JAX package's, from the same JAX-initialised variables converted by
fedml_tpu_torch/convert.py.

Tolerances:
- f32 logits and loss gradients: atol 1e-5. The two packages run the same
  f32 arithmetic through two blocks with sums taken in other orders
  (observed differences are ~2e-6 on logits of magnitude ~3).
- bf16 compute: logits atol 0.06 and gradients atol 0.01. Every Dense,
  residual add and the attention output round to bf16 (8 significant bits)
  at places where the two frameworks fuse differently; 0.06 is four bf16
  ulps at the logits' scale ([2, 4): ulp 2^-6), and gradients of magnitude
  up to ~0.5 carry a few bf16 ulps of theirs.
- ``remat=True`` (flash attention, no dropout: JAX's per-slot dropout keys
  cannot be reproduced): the loss and every gradient atol 1e-5 against the
  JAX model with ``remat=True``; the port's remat against its plain model
  bitwise, eagerly (``torch.utils.checkpoint``) and in the vmapped cohort
  (the remat ``autograd.Function`` under ``torch.func``), where a step's
  flash launches double (2L in place of L);
- dropout: a round stream's keep masks keep 0.9 +- 0.01 of the elements at
  rate 0.1; a vmapped step with dropout is bitwise the same from one seed
  twice, and with remat bitwise the plain step on the same masks (the
  replay applies the masks of the forward); the eval forward of the
  dropout model is bitwise the dropout-free model's."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import trainer as jtrainer
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu_torch import convert
from fedml_tpu_torch.core import trainer as ttrainer
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.ops import attention

V, D, L, H, T = 50, 32, 2, 4, 16


def _batch(rng):
    x = rng.randint(0, V, (2, T)).astype(np.int32)
    y = rng.randint(0, V, (2, T)).astype(np.int32)
    mask = np.ones((2, T), np.float32)
    mask[1, 10:] = 0.0
    return {"x": x, "y": y, "mask": mask}


def _jax_side(attn_impl, dtype, batch, remat=False):
    model = JaxLM(vocab_size=V, embed_dim=D, num_layers=L, num_heads=H, max_len=T,
                  attn_impl=attn_impl, dtype=dtype, remat=remat)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.tree.map(np.asarray, model.init(jax.random.key(0), jb["x"]))

    @jax.jit
    def logits_and_grads(params):
        def loss(p):
            return jtrainer.lm_loss(model.apply({"params": p}, jb["x"]), jb)
        return model.apply({"params": params}, jb["x"]), jax.grad(loss)(params)

    logits, grads = logits_and_grads(variables["params"])
    return variables, np.asarray(logits), jax.tree.map(np.asarray, grads)


def _torch_side(attn_impl, dtype, variables, batch, remat=False):
    model = TransformerLM(vocab_size=V, embed_dim=D, num_layers=L, num_heads=H, max_len=T,
                          attn_impl=attn_impl, dtype=dtype, remat=remat, device="cpu")
    model.load_state_dict(convert.from_flax(variables))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    logits = model(tb["x"])
    ttrainer.lm_loss(logits, tb).backward()
    grads = convert.to_flax({k: p.grad for k, p in model.named_parameters()})["params"]
    return logits.detach().numpy(), grads


def _assert_trees_close(a, b, atol):
    paths_a = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(paths_a) == len(flat_b)
    for path, leaf in paths_a:
        np.testing.assert_allclose(flat_b[path], leaf, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_f32_logits_and_grads_match_jax(rng, attn_impl):
    batch = _batch(rng)
    variables, logits, grads = _jax_side(attn_impl, jnp.float32, batch)
    t_logits, t_grads = _torch_side(attn_impl, torch.float32, variables, batch)
    assert t_logits.dtype == np.float32 and t_logits.shape == (2, T, V)
    np.testing.assert_allclose(t_logits, logits, atol=1e-5)
    _assert_trees_close(grads, t_grads, atol=1e-5)


def test_bf16_logits_and_grads_match_jax(rng):
    batch = _batch(rng)
    variables, logits, grads = _jax_side("flash", jnp.bfloat16, batch)
    t_logits, t_grads = _torch_side("flash", torch.bfloat16, variables, batch)
    assert t_logits.dtype == np.float32  # the f32 head's logits
    np.testing.assert_allclose(t_logits, logits, atol=0.06)
    _assert_trees_close(grads, t_grads, atol=0.01)


def test_converter_round_trip_and_layout(rng):
    variables, _, _ = _jax_side("xla", jnp.float32, _batch(rng))
    sd = convert.from_flax(variables)
    model = TransformerLM(vocab_size=V, embed_dim=D, num_layers=L, num_heads=H, max_len=T,
                          device="cpu")
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape, name
    qkv = variables["params"]["block_0"]["MultiHeadSelfAttention_0"]["qkv"]["kernel"]
    np.testing.assert_array_equal(sd["blocks.0.attn.qkv.weight"].numpy(), qkv.T)
    back = convert.to_flax(sd)
    _assert_trees_close(variables, back, atol=0.0)


def test_pos_offset_shifts_positions(rng):
    model = TransformerLM(vocab_size=V, embed_dim=D, num_layers=1, num_heads=H, max_len=2 * T,
                          device="cpu")
    x = torch.tensor(rng.randint(0, V, (1, T)))
    shifted = model(x, pos_offset=T)
    model.pos_embed.data[:T] = model.pos_embed.data[T:].clone()
    np.testing.assert_allclose(shifted.detach().numpy(), model(x).detach().numpy(), atol=1e-6)


def test_registry_and_unported_options():
    model = create_model("transformer", V, dtype="bfloat16", device="cpu", embed_dim=D,
                         num_layers=1, num_heads=H, max_len=T, attn_impl="flash")
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # the fedseg DeepLabLite builds, its variables convert to flax's tree and back
    deeplab = create_model("deeplab", 100, device="cpu")
    assert convert.from_flax(convert.to_flax(deeplab.state_dict())).keys() == \
        deeplab.state_dict().keys()
    assert "ASPP_0" in convert.to_flax(deeplab.state_dict())["params"]
    for kwargs in ({"attn_impl": "ring"}, {"mp_axis": "model"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            create_model("transformer", V, device="cpu", embed_dim=D, num_heads=H, **kwargs)


def _counted_flash(monkeypatch):
    """The plain flash forward's calls on the CPU, counted."""
    calls = []
    inner = attention._flash_fwd

    def counting(*args):
        calls.append(1)
        return inner(*args)

    monkeypatch.setattr(attention, "_flash_fwd", counting)
    return calls


def test_remat_matches_jax_and_plain_bitwise(rng, monkeypatch):
    batch = _batch(rng)
    variables, logits, grads = _jax_side("flash", jnp.float32, batch, remat=True)
    calls = _counted_flash(monkeypatch)
    t_logits, t_grads = _torch_side("flash", torch.float32, variables, batch, remat=True)
    assert len(calls) == 2 * L  # the forward and the backward's replay
    np.testing.assert_allclose(t_logits, logits, atol=1e-5)
    _assert_trees_close(grads, t_grads, atol=1e-5)
    calls.clear()
    p_logits, p_grads = _torch_side("flash", torch.float32, variables, batch)
    assert len(calls) == L
    np.testing.assert_array_equal(p_logits, t_logits)
    _assert_trees_close(p_grads, t_grads, atol=0.0)


def _vmap_step(remat, dropout_rate=0.0, seed=0):
    """One vmapped step of 2 clients of the flash LM: the stacked variables
    and losses, and the round stream it drew its masks from."""
    model = TransformerLM(vocab_size=V, embed_dim=D, num_layers=L, num_heads=H, max_len=T,
                          attn_impl="flash", remat=remat, dropout_rate=dropout_rate,
                          device="cpu")
    trainer = ttrainer.ClientTrainer(module=model, task="char_lm", optimizer=ttrainer.sgd(0.1))
    g0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(1)
    data = {"x": torch.tensor(rng.randint(0, V, (2, 1, 2, T))),
            "y": torch.tensor(rng.randint(0, V, (2, 1, 2, T))),
            "mask": torch.ones(2, 1, 2, T)}
    stream = (ttrainer.DropoutStream(trainer.dropout_sites, seed, 0, 2, 2, torch.device("cpu"))
              if dropout_rate else None)
    out, metrics = ttrainer.make_vmap_train(trainer)(g0, data, torch.tensor([1, 1]), None, stream)
    return out, metrics["train_loss"], stream


def test_remat_in_the_vmapped_cohort_is_bitwise_plain(monkeypatch):
    calls = _counted_flash(monkeypatch)
    plain, plain_loss, _ = _vmap_step(False)
    assert len(calls) == L
    calls.clear()
    remat, remat_loss, _ = _vmap_step(True)
    assert len(calls) == 2 * L
    assert torch.equal(plain_loss, remat_loss)
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k


def test_dropout_keeps_its_share_and_repeats(rng):
    model = TransformerLM(vocab_size=V, embed_dim=D, num_layers=L, num_heads=H, max_len=T,
                          dropout_rate=0.1, device="cpu")
    assert set(model.dropout_sites) == {f"blocks.{i}.{s}" for i in range(L)
                                        for s in ("attn", "mlp")}
    masks = ttrainer.DropoutStream(model.dropout_sites, 3, 0, 4, 8,
                                   torch.device("cpu")).masks(0)
    kept = torch.cat([m.flatten() for m in masks.values()]).float().mean()
    assert abs(float(kept) - 0.9) < 0.01
    # the eval forward ignores dropout
    plain = TransformerLM(vocab_size=V, embed_dim=D, num_layers=L, num_heads=H, max_len=T,
                          device="cpu")
    plain.load_state_dict(model.state_dict())
    x = torch.tensor(rng.randint(0, V, (2, T)))
    assert torch.equal(model(x), plain(x))
    with pytest.raises(ValueError, match="keep masks"):
        model(x, train=True)
    a, la, _ = _vmap_step(False, 0.1, seed=4)
    b, lb, _ = _vmap_step(False, 0.1, seed=4)
    r, lr_, _ = _vmap_step(True, 0.1, seed=4)
    c, lc, _ = _vmap_step(False, 0.1, seed=5)
    assert torch.equal(la, lb) and torch.equal(la, lr_) and not torch.equal(la, lc)
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], r[k]), k
