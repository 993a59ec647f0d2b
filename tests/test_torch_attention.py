"""The port's flash attention (fedml_tpu_torch/ops/attention.py) against the
JAX package's (fedml_tpu/ops/attention.py, Pallas kernel in interpret mode on
the CPU). On CPU tensors the port runs the kernel's plain version; the CUDA
kernel itself is held to that plain version on the card by chip_smoke.py.

Tolerances (f32): forward atol 1e-5 and gradients atol 1e-4, as the JAX
package's own flash tests hold its kernel to its oracle
(tests/test_longcontext.py:29,36,144); the two differ only in the order of
f32 sums."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
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


def _recording_kernel(monkeypatch):
    """Stand the kernels in with a recorder of their arguments, as if every
    tensor lay on a card, so the wrapper runs without one."""
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
    return calls


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "flash_fwd_sm90"),
                                        (torch.float32, "flash_fwd_f32_sm90")])
def test_wrapper_takes_more_than_65535_heads(monkeypatch, dtype, name):
    """B*H > 65535 reaches the kernel (B*H lies on grid.x): a recording
    stand-in for the kernel takes the launch, so no card is needed."""
    calls = _recording_kernel(monkeypatch)
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
        assert args[4:9] == (b, h, t, t, d)
        assert args[9:18] == (h * t * d, t * d, d) * 3
        assert (tattn.FLASH_FWD_BF16_LAUNCHES, tattn.FLASH_FWD_F32_LAUNCHES) == (0, 1)
    assert tattn.FLASH_FWD_LAUNCHES == 1


def test_forward_copies_only_views_tma_refuses(monkeypatch):
    """The autograd forward hands bf16 views that TMA takes to the kernel as
    they are (no .contiguous() copy) and copies the others."""
    calls = _recording_kernel(monkeypatch)
    q, k, v = _heads_of_qkv(torch.bfloat16)
    tattn._flash_fwd(q, k, v, True, 0.25, 16, 16)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    q_odd = flat[1:].view(q.shape)  # 2-byte aligned base: copied
    tattn._flash_fwd(q_odd, k, v, True, 0.25, 16, 16)
    (_, first), (_, second) = calls
    assert first[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert first[10:19] == tuple(x for t in (q, k, v) for x in t.stride()[:3])
    assert second[0] != q_odd.data_ptr() and second[1:3] == (k.data_ptr(), v.data_ptr())
    assert tattn.FLASH_FWD_BF16_LAUNCHES == 2


def test_f32_views_reach_the_kernel_uncopied(monkeypatch):
    """The f32 forward hands the main path's strided q/k/v views of one qkv
    projection to the f32 kernel as they are, with their own strides."""
    calls = _recording_kernel(monkeypatch)
    q, k, v = _heads_of_qkv(torch.float32)
    tattn._flash_fwd(q, k, v, True, 0.25, 16, 16)
    [(name, args)] = calls
    assert name == "flash_fwd_f32_sm90"
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[4:9] == (2, 4, 16, 16, 8)
    assert args[9:18] == tuple(x for t in (q, k, v) for x in t.stride()[:3])
    assert args[9:12] == (16 * 3 * 4 * 8, 8, 3 * 4 * 8)  # (batch, head, token)
    assert (tattn.FLASH_FWD_F32_LAUNCHES, tattn.FLASH_FWD_BF16_LAUNCHES) == (1, 0)


def test_misaligned_f32_view_is_copied(monkeypatch):
    """An f32 view the kernel cannot take (a base 4 bytes off 16-byte
    alignment) is copied into a fresh contiguous tensor; the others are not."""
    calls = _recording_kernel(monkeypatch)
    q, k, v = _heads_of_qkv(torch.float32)
    flat = torch.zeros(q.numel() + 1, dtype=torch.float32)
    q_odd = flat[1:].view(q.shape)
    assert q_odd.is_contiguous() and not tattn.tma_compatible(q_odd)
    tattn._flash_fwd(q_odd, k, v, False, 0.25, 16, 16)
    [(name, args)] = calls
    assert name == "flash_fwd_f32_sm90"
    assert args[0] != q_odd.data_ptr() and args[1:3] == (k.data_ptr(), v.data_ptr())
    assert args[9:12] == (4 * 16 * 8, 16 * 8, 8)  # the copy is contiguous
    assert tattn.FLASH_FWD_F32_LAUNCHES == 1


# A model of the f32 kernel's arithmetic (csrc/flash_fwd_f32_sm90.cu): each
# product is taken in three TF32 passes over operands split as x = big + small.
# The kernel truncates (big = x with its 13 low mantissa bits cleared, and the
# tensor cores read small's top 19 bits); the textbook split rounds both parts
# to nearest with cvt.rna.tf32.f32. Both are modelled.

def tf32_rna(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 does: add half of the 13 dropped bits' weight to
    the magnitude, then clear them (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """Clear the 13 mantissa bits f32 has beyond TF32's (round toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product_3xtf32(a, b, to_tf32):
    """a @ b in three TF32 passes: x = big + small with big = to_tf32(x) and
    small = to_tf32(x - big), and the products small.big, big.small, big.big
    summed in that order, as the kernel issues them."""
    a_big, b_big = to_tf32(a), to_tf32(b)
    a_small, b_small = to_tf32(a - a_big), to_tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _product_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def _flash_model(q, k, v, causal, product, bq=128, bk=64):
    """The f32 kernel's math in torch: its tiles (128 queries, 64 keys),
    q * sm_scale in f32, the online softmax in f32 with masked p = 0, and both
    products through ``product``."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    off = t_k - t_q
    qf = q * d ** -0.5
    out = []
    for iq in range(-(-t_q // bq)):
        qb = qf[:, :, iq * bq:(iq + 1) * bq]
        q_pos = off + iq * bq + torch.arange(qb.shape[2])[:, None]
        o = torch.zeros(b, h, qb.shape[2], d)
        l = torch.zeros(b, h, qb.shape[2], 1)
        m = torch.full((b, h, qb.shape[2], 1), tattn.NEG_INF)
        for j in range(-(-t_k // bk)):
            kb, vb = k[:, :, j * bk:(j + 1) * bk], v[:, :, j * bk:(j + 1) * bk]
            s = product(qb, kb.transpose(-1, -2))
            if causal:
                k_pos = j * bk + torch.arange(kb.shape[2])[None, :]
                s = torch.where(k_pos <= q_pos, s, tattn.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(s <= tattn.NEG_INF / 2, 0.0, torch.exp(s - m_new))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + product(p, vb)
            m = m_new
        out.append(o / torch.clamp(l, min=1e-20))
    return torch.cat(out, dim=2)


def test_tf32_rounding_models():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 3.0, -0.0])
    assert tf32_rna(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0, -0.0]
    assert tf32_trunc(x).tolist() == [1.0, -1.0, 1.0, 1.0, 3.0, -0.0]
    # the split is exact: big + small gives x back, and small is below one TF32 ulp of x
    y = torch.tensor(np.random.RandomState(3).randn(1000).astype(np.float32))
    big = tf32_trunc(y)
    assert torch.equal(big + (y - big), y)
    assert bool(((y - big).abs() < y.abs() * ulp).all())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("to_tf32", [tf32_trunc, tf32_rna], ids=["trunc", "rna"])
def test_3xtf32_model_matches_plain(causal, to_tf32):
    """3xTF32 arithmetic agrees with flash_attention_plain within FWD_ATOL at
    the main path's head dim (D=128, T=256): with the kernel's truncating
    split 1.3e-06 causal and 8.9e-07 full, with round-to-nearest splits
    1.5e-06 and 8.3e-07. One TF32 product (operands rounded to nearest once)
    misses by 9.7e-04 causal and 4.2e-04 full, more than the 1e-4 f32 parity
    the kernel is held to on the card: that is why the kernel takes three."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.tensor(rng.randn(1, 2, 256, 128).astype(np.float32)) for _ in range(3))
    plain = tattn.flash_attention_plain(q, k, v, causal)
    three = _flash_model(q, k, v, causal, lambda a, b: _product_3xtf32(a, b, to_tf32))
    one = _flash_model(q, k, v, causal, _product_tf32)
    np.testing.assert_allclose(three.numpy(), plain.numpy(), atol=FWD_ATOL)
    assert float((one - plain).abs().max()) > 1e-4
