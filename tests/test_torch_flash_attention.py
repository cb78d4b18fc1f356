"""Port flash attention (imageclassification_tpu_torch/ops/flash_attention.py)
against the JAX package's `flash_attention_fn`, which runs the Pallas TPU
kernel; here that kernel runs in interpret mode on the CPU, the way
tests/test_pallas_layernorm.py runs its kernel. On the CPU the port's wrapper
takes its plain version; the CUDA kernel is checked by the `cuda` tests on a
card (and by chip_smoke.py). The JAX package is imported inside the test that
uses it, so the `cuda` tests of this file also run where JAX is absent:

    python -m pytest --noconftest tests/test_torch_flash_attention.py -m cuda
"""

import numpy as np
import pytest
import torch

from imageclassification_tpu_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_flash_attention(monkeypatch):
    """The JAX `flash_attention_fn`, its Pallas kernel in interpret mode."""
    import jax.experimental.pallas as pl

    from imageclassification_tpu.models.vit import flash_attention_fn

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    return flash_attention_fn


@pytest.fixture
def launches(monkeypatch):
    monkeypatch.setattr(fa.flash_attention, "launches", 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash-attention kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("n", [5, 128, 197])
def test_ref_matches_jax_flash_kernel(jax_flash_attention, n):
    # fp32 on both sides. The JAX kernel pads N to a multiple of 128 and masks
    # the padded keys by segment id; the plain version pads nothing. Same
    # function, so only the summation order differs: atol 1e-5.
    q, k, v = _qkv((2, n, 3, 64), seed=n)
    want = np.asarray(jax_flash_attention(q, k, v))
    got = fa.flash_attention_ref(*map(torch.from_numpy, (q, k, v))).numpy()
    assert got.shape == want.shape == (2, n, 3, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_takes_plain_version_and_launches_nothing(launches, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv((2, 197, 3, 64), seed=1))
    out = fa.flash_attention(q, k, v)
    assert out.dtype == dtype
    torch.testing.assert_close(out, fa.flash_attention_ref(q, k, v), rtol=0, atol=0)
    assert fa.flash_attention.launches == 0


def test_cpu_wrapper_reads_strided_qkv_views():
    # the ViT hands the wrapper views into one fused [B, N, 3, H, D] tensor
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 197, 3, 3, 64)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    torch.testing.assert_close(
        fa.flash_attention(q, k, v),
        fa.flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous()),
        rtol=0, atol=0,
    )


@pytest.mark.parametrize(
    "dtype,shape,err",
    [
        (torch.float32, (2, 9, 3, 64), NotImplementedError),   # dtype gap
        (torch.float16, (2, 9, 3, 64), NotImplementedError),   # dtype gap
        (torch.bfloat16, (2, 9, 3, 32), NotImplementedError),  # head_dim gap
        (torch.bfloat16, (2, 9, 3, 64), None),
    ],
)
def test_kernel_input_checks(dtype, shape, err):
    q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    if err is None:
        fa.check_kernel_inputs(q, k, v)
    else:
        with pytest.raises(err):
            fa.check_kernel_inputs(q, k, v)


def test_kernel_input_checks_reject_unreadable_layouts():
    qkv = torch.zeros((2, 9, 3, 3, 64), dtype=torch.bfloat16)
    fa.check_kernel_inputs(*qkv.unbind(2))  # strided views are fine
    q = torch.zeros((2, 9, 3, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # strides differ between q and k
        fa.check_kernel_inputs(q, qkv[:, :, 1], qkv[:, :, 2])
    with pytest.raises(ValueError):  # D not unit-stride
        t = torch.zeros((2, 9, 64, 3), dtype=torch.bfloat16).transpose(2, 3)
        fa.check_kernel_inputs(t, t, t)


def test_backward_raises_until_ported():
    with pytest.raises(NotImplementedError):
        fa._FlashAttentionFwd.backward(None, torch.zeros(1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 65, 197, 577])
def test_kernel_matches_plain_version_on_card(cuda_device, launches, n):
    # bf16 in and out, fp32 accumulation in both; the kernel rounds P to
    # bf16 before P.V, so atol 2e-2 on outputs of magnitude <= ~3
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv((2, n, 12, 64), seed=n))
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == 1
    torch.testing.assert_close(out.float(), fa.flash_attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_kernel_reads_fused_qkv_views_on_card(cuda_device):
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((4, 197, 3, 12, 64)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
