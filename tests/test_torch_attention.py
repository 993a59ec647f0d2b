"""The port's flash attention (fedml_tpu_torch/ops/attention.py) against the
JAX package's (fedml_tpu/ops/attention.py, Pallas kernel in interpret mode on
the CPU). On CPU tensors the port runs the kernel's plain version; the CUDA
kernel itself is held to that plain version on the card by chip_smoke.py.

Tolerances (f32): forward atol 1e-5 and gradients atol 1e-4, as the JAX
package's own flash tests hold its kernel to its oracle
(tests/test_longcontext.py:29,36,144); the two differ only in the order of
f32 sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import attention as jattn
from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.ops import attention as tattn

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _qkv(rng, b=2, h=2, tq=64, tk=64, d=8):
    return (rng.randn(b, h, tq, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32))


def _jax_flash(q, k, v, causal, block):
    return np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, block, block))


def _torch_flash(q, k, v, causal, block):
    return tattn.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                 causal, None, block, block).numpy()


@pytest.mark.parametrize("tq,tk,causal", [
    (64, 64, False), (64, 64, True), (48, 32, True), (32, 48, True), (32, 48, False),
])
def test_plain_matches_jax_flash(rng, tq, tk, causal):
    q, k, v = _qkv(rng, tq=tq, tk=tk)
    out = _torch_flash(q, k, v, causal, 16)
    np.testing.assert_allclose(out, _jax_flash(q, k, v, causal, 16), atol=FWD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_jax_reference(rng, causal):
    q, k, v = _qkv(rng, tq=40, tk=56)
    ref = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    out = tattn.attention_reference(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL)


def test_fully_masked_rows_are_zero(rng):
    """Causal with t_q > t_k right-aligns the keys: the first t_q - t_k rows
    see nothing. The kernel, and so the plain version, writes 0 there, where
    attention_reference returns the mean of v."""
    q, k, v = _qkv(rng, tq=24, tk=8)
    out = _torch_flash(q, k, v, True, 8)
    np.testing.assert_array_equal(out[:, :, :16], 0.0)
    np.testing.assert_allclose(out, _jax_flash(q, k, v, True, 8), atol=FWD_ATOL)
    ref = tattn.attention_reference(torch.tensor(q), torch.tensor(k), torch.tensor(v), True)
    np.testing.assert_allclose(ref[:, :, :16].numpy(),
                               np.broadcast_to(v.mean(2, keepdims=True), (2, 2, 16, 8)),
                               atol=FWD_ATOL)


@pytest.mark.parametrize("tq,tk,block", [(32, 32, 8), (16, 8, 8), (24, 40, 8)])
def test_gradients_match_jax(rng, tq, tk, block):
    q, k, v = _qkv(rng, tq=tq, tk=tk)
    cot = rng.randn(*q.shape).astype(np.float32)  # nonzero on fully masked rows too

    def loss_jax(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, True, None, block, block) * cot)

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = tattn.flash_attention(*leaves, True, None, block, block)
    (out * torch.tensor(cot)).sum().backward()
    for gj, leaf in zip(g_jax, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gj), atol=GRAD_ATOL)
    if tq > tk:
        np.testing.assert_array_equal(leaves[0].grad[:, :, : tq - tk].numpy(), 0.0)


def test_cpu_tensors_never_launch_the_kernel(rng):
    before = tattn.FLASH_FWD_LAUNCHES
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _qkv(rng, tq=16, tk=16))
    tattn.flash_attention(q, k, v, True).sum().backward()
    tattn.flash_attention(q, k, v, False)
    assert tattn.FLASH_FWD_LAUNCHES == before == 0


def test_kernel_wrapper_rejects_cpu_tensors(rng):
    q, k, v = (torch.tensor(a) for a in _qkv(rng, tq=16, tk=16))
    with pytest.raises(ValueError, match="not a CUDA device"):
        tattn.flash_fwd_cuda(q, k, v, True, 0.25)
    assert tattn.FLASH_FWD_LAUNCHES == 0


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card error")
    from fedml_tpu_torch.device import resolve_device
    from fedml_tpu_torch.models.registry import create_model
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        create_model("transformer", 50, embed_dim=16, num_layers=1, num_heads=2, max_len=8)
    with pytest.raises(RuntimeError, match="cuda"):
        FedSim(None, None, None, SimConfig())  # the default device is the card


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_pick_block_matches_jax():
    for t in (1, 7, 16, 100, 300, 1024):
        for pref in (8, 128, 256, 1024):
            assert tattn._pick_block(t, pref) == jattn._pick_block(t, pref)
