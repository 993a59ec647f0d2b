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


# chip_smoke.py's bf16 tolerance, against flash_attention_plain
BF16_ATOL, BF16_RTOL = 2.0 ** -6, 2.0 ** -7


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_rounding_fits_the_kernel_tolerance(causal):
    """The bf16 kernel rounds p to bf16 for the P.V product, as
    attention_reference (the JAX oracle's math) casts p to v's type; the plain
    version keeps p in f32. At the main path's head dim, that rounding stays
    within the tolerance the kernel is held to on the card."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.tensor(rng.randn(1, 4, 256, 128).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    ref = tattn.attention_reference(q, k, v, causal).float()
    plain = tattn.flash_attention_plain(q, k, v, causal).float()
    assert ref.dtype == plain.dtype and ref.shape == (1, 4, 256, 128)
    assert bool(((ref - plain).abs() <= BF16_ATOL + BF16_RTOL * plain.abs()).all())


def _heads_of_qkv(dtype, b=2, t=16, h=4, d=8):
    """q, k, v as the main path makes them: the split of one fused [B, T, 3C]
    projection, reshaped to heads and transposed to [B, H, T, D]."""
    qkv = torch.zeros(b, t, 3 * h * d, dtype=dtype)
    return [a.reshape(b, t, h, d).transpose(1, 2) for a in qkv.split(h * d, dim=-1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tma_takes_the_main_path_views(dtype):
    views = _heads_of_qkv(dtype)
    assert not any(t.is_contiguous() for t in views)
    assert all(tattn.tma_compatible(t) for t in views)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tma_refuses_misaligned_and_strided_views(dtype):
    flat = torch.zeros(4 * 2 * 16 * 8 + 1, dtype=dtype)
    assert tattn.tma_compatible(flat[:-1].view(4, 2, 16, 8))
    assert not tattn.tma_compatible(flat[1:].view(4, 2, 16, 8))  # base off by one element
    wide = torch.zeros(4, 2, 16, 16, dtype=dtype)
    assert not tattn.tma_compatible(wide[..., ::2])  # last stride 2
    assert not tattn.tma_compatible(wide[..., :8].transpose(-1, -2))


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "flash_fwd_sm90"),
                                        (torch.float32, "flash_fwd")])
def test_wrapper_takes_more_than_65535_heads(monkeypatch, dtype, name):
    """B*H > 65535 reaches the kernel (B*H lies on grid.x): a recording
    stand-in for the kernel takes the launch, so no card is needed."""
    calls = []

    def fake_kernel(kernel_name):
        def launch(*args):
            calls.append((kernel_name, args))
            return 0
        return launch

    monkeypatch.setattr(tattn, "_kernel", fake_kernel)
    monkeypatch.setattr(tattn, "_is_cuda", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    for counter in ("FLASH_FWD_LAUNCHES", "FLASH_FWD_BF16_LAUNCHES", "FLASH_FWD_F32_LAUNCHES"):
        monkeypatch.setattr(tattn, counter, 0)
    b, h, t, d = 1040, 64, 16, 8
    q, k, v = (torch.empty(b, h, t, d, dtype=dtype) for _ in range(3))
    out = tattn.flash_fwd_cuda(q, k, v, True, d ** -0.5)
    assert out.shape == (b, h, t, d) and out.dtype == dtype
    [(kernel_name, args)] = calls
    assert kernel_name == name
    if dtype == torch.bfloat16:
        assert args[5:10] == (b, h, t, t, d)
        assert args[10:19] == (h * t * d, t * d, d) * 3  # (batch, head, token) strides
        assert (tattn.FLASH_FWD_BF16_LAUNCHES, tattn.FLASH_FWD_F32_LAUNCHES) == (1, 0)
    else:
        assert args[4:8] == (b * h, t, t, d)
        assert (tattn.FLASH_FWD_BF16_LAUNCHES, tattn.FLASH_FWD_F32_LAUNCHES) == (0, 1)
    assert tattn.FLASH_FWD_LAUNCHES == 1


def test_forward_copies_only_views_tma_refuses(monkeypatch):
    """The autograd forward hands bf16 views that TMA takes to the kernel as
    they are (no .contiguous() copy) and copies the others."""
    calls = []

    def fake_kernel(kernel_name):
        def launch(*args):
            calls.append(args)
            return 0
        return launch

    monkeypatch.setattr(tattn, "_kernel", fake_kernel)
    monkeypatch.setattr(tattn, "_is_cuda", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    for counter in ("FLASH_FWD_LAUNCHES", "FLASH_FWD_BF16_LAUNCHES", "FLASH_FWD_F32_LAUNCHES"):
        monkeypatch.setattr(tattn, counter, 0)
    q, k, v = _heads_of_qkv(torch.bfloat16)
    tattn._flash_fwd(q, k, v, True, 0.25, 16, 16)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    q_odd = flat[1:].view(q.shape)  # 2-byte aligned base: copied
    tattn._flash_fwd(q_odd, k, v, True, 0.25, 16, 16)
    (first, second) = calls
    assert first[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert first[10:19] == tuple(x for t in (q, k, v) for x in t.stride()[:3])
    assert second[0] != q_odd.data_ptr() and second[1:3] == (k.data_ptr(), v.data_ptr())
    assert tattn.FLASH_FWD_BF16_LAUNCHES == 2
