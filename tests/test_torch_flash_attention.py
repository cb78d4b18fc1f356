"""Port flash attention (imageclassification_tpu_torch/ops/flash_attention.py)
against the JAX package's `flash_attention_fn`, which runs the Pallas TPU
kernel, forward and, under `jax.grad`, the backward (dK/dV and dQ kernels);
here those kernels run in interpret mode on the CPU, the way
tests/test_pallas_layernorm.py runs its kernel. On the CPU the port's wrapper
takes its plain version; the CUDA kernels are checked by the `cuda` tests on a
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
    for name in ("launches", "launches_lse", "launches_dkv", "launches_dq"):
        monkeypatch.setattr(fa.flash_attention, name, 0)


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


@pytest.fixture(scope="module")
def jax_flash_grads():
    """get(n) -> (q, k, v, g, (dq, dk, dv)): jax.grad of sum(g * out) through
    the JAX `flash_attention_fn` at (2, n, 3, 64) fp32, its Pallas forward and
    backward (dK/dV, dQ) kernels in interpret mode; computed once per n."""
    import jax
    import jax.experimental.pallas as pl
    import jax.numpy as jnp

    from imageclassification_tpu.models.vit import flash_attention_fn

    cache = {}

    def get(n):
        if n not in cache:
            q, k, v, g = _qkv((2, n, 3, 64), seed=10 + n) + _qkv((2, n, 3, 64), seed=20 + n)[:1]
            orig = pl.pallas_call
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(pl, "pallas_call",
                           lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
                grads = jax.grad(lambda q, k, v: jnp.sum(flash_attention_fn(q, k, v) * g),
                                 argnums=(0, 1, 2))(q, k, v)
            cache[n] = (q, k, v, g, tuple(np.asarray(x) for x in grads))
        return cache[n]

    return get


@pytest.mark.parametrize("n", [5, 128, 197])
@pytest.mark.parametrize("impl", ["bwd_ref", "autograd"])
def test_backward_matches_jax_flash_kernels(jax_flash_grads, impl, n):
    # fp32 on both sides: the JAX gradients come from the Pallas dK/dV and dQ
    # kernels (N padded to 128, padded keys masked by segment id); the port's
    # from `flash_attention_bwd_ref` on the forward's lse, or from autograd
    # through the plain forward that the CPU wrapper takes. Same function,
    # only the summation order differs: atol 1e-4 (measured <= 4e-5).
    q, k, v, g, want = jax_flash_grads(n)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    if impl == "bwd_ref":
        o = fa.flash_attention_ref(tq, tk, tv)
        got = fa.flash_attention_bwd_ref(tq, tk, tv, o, fa.flash_attention_lse_ref(tq, tk), tg)
    else:
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        (fa.flash_attention(*leaves) * tg).sum().backward()
        got = [t.grad for t in leaves]
    assert np.abs(want[0]).max() > 0.1  # the gradients are not degenerate
    for name, gt, w in zip("qkv", got, want):
        assert gt.shape == w.shape == (2, n, 3, 64)
        np.testing.assert_allclose(gt.numpy(), w, atol=1e-4, rtol=0, err_msg=f"d{name}")


def test_lse_ref_normalises_the_softmax():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 37, 3, 64), seed=4))
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * 64 ** -0.5
    p = torch.exp(s - fa.flash_attention_lse_ref(q, k)[..., None])
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 3, 37), atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.einsum("bhnm,bmhd->bnhd", p, v),
                               fa.flash_attention_ref(q, k, v), atol=1e-5, rtol=0)


def test_cpu_wrapper_backward_launches_nothing(launches):
    # bf16 autograd through strided fused-qkv views, as a training step on the
    # CPU runs it: plain torch code, no kernel
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 9, 3, 3, 64)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16).requires_grad_()
    fa.flash_attention(*qkv.unbind(2)).float().square().sum().backward()
    assert qkv.grad.shape == qkv.shape and torch.isfinite(qkv.grad.float()).all()
    assert (fa.flash_attention.launches, fa.flash_attention.launches_lse,
            fa.flash_attention.launches_dkv, fa.flash_attention.launches_dq) == (0, 0, 0, 0)


def test_backward_input_checks():
    q, k, v = torch.zeros((3, 2, 9, 3, 64), dtype=torch.bfloat16).unbind(0)
    lse = torch.zeros((2, 3, 9))
    do = torch.ones((2, 9, 64, 3), dtype=torch.bfloat16).transpose(2, 3)  # D not unit-stride
    got_do, di = fa._bwd_inputs(q, k, v, q, lse, do)
    assert got_do.is_contiguous() and di.shape == (2, 3, 9) and di.dtype == torch.float32
    with pytest.raises(ValueError, match="lse"):
        fa._bwd_inputs(q, k, v, q, lse[:, :, :-1], do)
    with pytest.raises(ValueError, match="do"):
        fa._bwd_inputs(q, k, v, q, lse, do[:, :-1])
    with pytest.raises(NotImplementedError):
        fa._bwd_inputs(q.float(), k.float(), v.float(), q, lse, do)


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


def _card_qkv(n, device, seed, heads=12):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, n, 3, heads, 64)).astype(np.float32)
    return torch.from_numpy(a).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 65, 197, 577])
def test_forward_lse_matches_logsumexp_on_card(cuda_device, launches, n):
    q, k, v = _card_qkv(n, cuda_device, seed=n).unbind(2)
    out, lse = fa._launch(q, k, v, with_lse=True)
    plain_out, none = fa._launch(q, k, v)
    torch.cuda.synchronize()
    assert none is None and fa.flash_attention.launches_lse == 1
    assert fa.flash_attention.launches == 2
    torch.testing.assert_close(out, plain_out, rtol=0, atol=0)  # lse changes nothing in o
    # fp32 sums of exp2 in the kernel against torch.logsumexp of the fp32
    # scores of the same bf16 inputs; lse is about log(N) + max score
    torch.testing.assert_close(lse, fa.flash_attention_lse_ref(q, k), atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 65, 197, 577])
def test_backward_kernels_match_plain_version_on_card(cuda_device, launches, n):
    qkv = _card_qkv(n, cuda_device, seed=n).requires_grad_()
    q, k, v = qkv.unbind(2)
    g = _card_qkv(n, cuda_device, seed=100 + n)[:, :, 0]
    fa.flash_attention(q, k, v).backward(g)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention.launches_lse,
            fa.flash_attention.launches_dkv, fa.flash_attention.launches_dq) == (1, 1, 1, 1)
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    want = fa.flash_attention_bwd_ref(qf, kf, vf, fa.flash_attention_ref(qf, kf, vf),
                                      fa.flash_attention_lse_ref(qf, kf), g.float())
    for name, got, w in zip("qkv", qkv.grad.unbind(2), want):
        # bf16 outputs, and P and dS rounded to bf16 before their products:
        # 2^-6 of the largest reference value, plus 1e-5 for a gradient that
        # vanishes (dq at N = 1, where the softmax is constant: dP - di is 0
        # up to fp32 summation order, ~1e-7)
        tol = 2.0 ** -6 * w.abs().max().item() + 1e-5
        err = (got.float() - w).abs().max().item()
        assert err <= tol, f"d{name}: max|d| {err} > {tol}"
