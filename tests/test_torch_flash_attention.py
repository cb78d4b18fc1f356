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

import math
import re
from pathlib import Path

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
    for name in fa.LAUNCH_COUNTS:
        monkeypatch.setattr(fa.flash_attention, name, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash-attention kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("n", [5, 65, 128, 197])
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
        (torch.float32, (2, 9, 3, 64), None),                  # the fp32 kernels
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


def test_tensor_map_layout_of_fused_and_contiguous_views():
    # the forward kernel's TMA tensor maps: dims (D, H, N, B) innermost first
    # and the byte strides of H, N, B, read straight from the view
    B, N, H = 2, 197, 12
    q = torch.zeros((B, N, 3, H, 64), dtype=torch.bfloat16).unbind(2)[0]
    assert fa.tensor_map_layout(q) == ((64, H, N, B), (128, 3 * H * 128, N * 3 * H * 128))
    c = torch.zeros((B, N, H, 64), dtype=torch.bfloat16)
    assert fa.tensor_map_layout(c) == ((64, H, N, B), (128, H * 128, N * H * 128))


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((2, 9, 3, 68), dtype=torch.bfloat16)[..., :64],  # H stride 136 B
    lambda: torch.zeros((2, 9, 64, 3), dtype=torch.bfloat16).transpose(2, 3),  # D strided
    lambda: torch.zeros((2, 9, 64), dtype=torch.bfloat16),  # not [B, N, H, D]
])
def test_tensor_map_layout_rejects_what_tma_cannot_read(make):
    with pytest.raises(ValueError):
        fa.tensor_map_layout(make())


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


@pytest.mark.parametrize("n", [5, 65, 128, 197])
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


@pytest.mark.parametrize("make", [
    # H stride 8 bytes past 64 elements: not a multiple of 16
    lambda dt, es: torch.zeros((2, 9, 3, 64 + 8 // es), dtype=dt)[..., :64],
    lambda dt, es: torch.zeros((2, 9, 64, 3), dtype=dt).transpose(2, 3),  # D strided
    lambda dt, es: torch.zeros((1, 3, 64), dtype=dt).expand(2, 9, 3, 64),  # stride 0
    lambda dt, es: torch.zeros(2 * 9 * 3 * 64 + 1, dtype=dt)[1:].view(2, 9, 3, 64),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_backward_reads_o_and_do_through_tensor_maps(make, dtype):
    # the dQ kernel reads O (for di) and dO through tensor maps of their own
    # strides, in bf16 and in fp32: an O that TMA cannot read raises (the
    # forward kernel writes it contiguous), a dO that it cannot read is copied
    # to one it can, and a readable dO is read in place
    es = torch.tensor([], dtype=dtype).element_size()
    q, k, v = torch.zeros((2, 9, 3, 3, 64), dtype=dtype).unbind(2)
    lse = torch.zeros((2, 3, 9))
    bad = make(dtype, es)
    with pytest.raises(ValueError, match="tensor map"):
        fa._bwd_inputs(q, k, v, bad, lse, q)
    got_do, (_, o_strides, do_strides) = fa._bwd_inputs(q, k, v, q, lse, bad)
    assert got_do.is_contiguous() and torch.equal(got_do, bad)
    row = 64 * es
    assert o_strides == (row, 3 * 3 * row, 9 * 3 * 3 * row)
    assert do_strides == (row, 3 * row, 9 * 3 * row)
    strided_do = torch.zeros((2, 3, 9, 64), dtype=dtype).transpose(1, 2)
    got_do, (_, _, do_strides) = fa._bwd_inputs(q, k, v, q, lse, strided_do)
    assert got_do is strided_do and do_strides == (9 * row, row, 3 * 9 * row)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_di_ref_matches_jax_expression(dtype):
    # the di that the dQ kernel writes for the dK/dV kernel: the JAX
    # backward's jnp expression (flash_attention.py:273-275) over [B, H, N,
    # D], here from [B, N, H, D] inputs; fp32 sums of the same products, only
    # the order differs: 1e-5 of the largest value
    import jax.numpy as jnp

    rng = np.random.default_rng(30)
    o, do = (rng.standard_normal((2, 37, 3, 64)).astype(np.float32) for _ in range(2))
    if dtype == "bfloat16":
        o, do = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (o, do))
    want = np.asarray(jnp.sum(jnp.transpose(o, (0, 2, 1, 3)).astype(jnp.float32)
                              * jnp.transpose(do, (0, 2, 1, 3)).astype(jnp.float32), axis=-1))
    got = fa.flash_attention_di_ref(torch.from_numpy(o), torch.from_numpy(do))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 3, 37)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


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
    got_do, strides = fa._bwd_inputs(q, k, v, q, lse, do)
    # a dO that no tensor map reads is copied; the byte strides of the maps
    # of q (shared by k, v), o and dO
    assert got_do.is_contiguous() and torch.equal(got_do, do)
    assert strides == ((128, 384, 3456), (128, 384, 3456), (128, 384, 3456))
    with pytest.raises(ValueError, match="lse"):
        fa._bwd_inputs(q, k, v, q, lse[:, :, :-1], do)
    with pytest.raises(ValueError, match="do"):
        fa._bwd_inputs(q, k, v, q, lse, do[:, :-1])
    # fp32 q, k, v take the fp32 kernels, whose o and dO are fp32 too; a
    # dtype the kernels do not take at all raises NotImplementedError
    with pytest.raises(ValueError, match="dtype"):
        fa._bwd_inputs(q.float(), k.float(), v.float(), q, lse, do)
    fa._bwd_inputs(q.float(), k.float(), v.float(), q.float(), lse, do.float())
    with pytest.raises(NotImplementedError):
        fa._bwd_inputs(q.half(), k.half(), v.half(), q.half(), lse, do.half())


def test_launch_structure_has_the_c_structs_fields_in_order():
    # ctypes lays a Structure out by its _fields_ order: it must be the C
    # struct's, arrays of the same lengths (the size check against both
    # libraries runs on the card)
    src = (Path(fa.__file__).parent.parent / "csrc" / "flash_attention_common.cuh").read_text()
    body = re.search(r"struct FlashLaunch \{(.*?)\n\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(?:long long|int|float)\s+(\w+)(?:\[(\d+)\])?;", body, re.M)
    assert [f for f, _ in fa._Launch._fields_] == [name for name, _ in fields]
    for (_, ctype), (_, n) in zip(fa._Launch._fields_, fields):
        assert getattr(ctype, "_length_", None) == (int(n) if n else None)


def test_launch_arguments_are_cached_by_shape_and_layout():
    fa._launch_args.cache_clear()
    a = fa._launch_args(2, 197, 12, 64, 0, (128, 4608, 907776))
    assert fa._launch_args(2, 197, 12, 64, 0, (128, 4608, 907776)) is a
    assert (a.B, a.N, a.H, a.device, list(a.qkv_stride), list(a.o_stride)) == \
        (2, 197, 12, 0, [128, 4608, 907776], [0, 0, 0])
    assert a.sm_scale == pytest.approx(0.125)
    assert fa._launch_args(2, 197, 12, 64, 1, (128, 4608, 907776)) is not a


@pytest.mark.cuda
@pytest.mark.parametrize("needs_grad", [False, True])
def test_autograd_node_only_when_an_input_requires_a_gradient_on_card(cuda_device, launches,
                                                                       needs_grad):
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv((2, 65, 12, 64), seed=4))
    out = fa.flash_attention(q.requires_grad_(needs_grad), k, v)
    assert (out.grad_fn is not None) == needs_grad
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == 2
    assert fa.flash_attention.launches_lse == int(needs_grad)


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


BWD_CARD_N = [1, 5, 63, 64, 65, 127, 128, 129, 197, 577, 1025]


@pytest.mark.cuda
@pytest.mark.parametrize("n", BWD_CARD_N)
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


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 129, 197, 577, 1025])
def test_forward_on_fused_qkv_views_on_card(cuda_device, launches, n, with_lse):
    # every ragged tail against the 64-key tiles and 128-row query blocks;
    # bf16 output: 2^-7 of the largest reference value (P rounded to bf16
    # before P.V, the output rounded once); lse as logsumexp of fp32 scores
    q, k, v = _card_qkv(n, cuda_device, seed=7 * n).unbind(2)
    out, lse = fa._launch(q, k, v, with_lse=with_lse)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == 1 and fa.flash_attention.launches_lse == int(with_lse)
    ref = fa.flash_attention_ref(q.float(), k.float(), v.float())
    assert out.is_contiguous() and out.shape == q.shape
    err = (out.float() - ref).abs().max().item()
    assert err <= 2.0 ** -7 * ref.abs().max().item(), f"max|d| {err}"
    if with_lse:
        torch.testing.assert_close(lse, fa.flash_attention_lse_ref(q, k), atol=1e-3, rtol=0)
    else:
        assert lse is None


@pytest.mark.cuda
@pytest.mark.parametrize("n", BWD_CARD_N)
def test_backward_kernels_take_the_forward_lse_on_card(cuda_device, launches, n):
    # the backward kernels on the forward kernel's o and lse, q, k, v strided
    # out of one fused tensor and dO a strided view of another, against the
    # fp32 plain backward: 2^-6 of the largest reference gradient (+1e-5 for
    # dq at N = 1, which vanishes); one launch of each kernel, dQ first
    q, k, v = _card_qkv(n, cuda_device, seed=9 * n).unbind(2)
    do = _card_qkv(n, cuda_device, seed=11 * n)[:, :, 0]
    assert not do.is_contiguous()
    o, lse = fa._launch(q, k, v, with_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_dq, fa.flash_attention.launches_dkv) == (1, 1)
    qf, kf, vf = (t.float() for t in (q, k, v))
    want = fa.flash_attention_bwd_ref(qf, kf, vf, fa.flash_attention_ref(qf, kf, vf),
                                      fa.flash_attention_lse_ref(qf, kf), do.float())
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        err = (got.float() - w).abs().max().item()
        assert err <= 2.0 ** -6 * w.abs().max().item() + 1e-5, f"{name}: max|d| {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 197, 1025])
def test_dq_kernel_writes_di_on_card(cuda_device, launches, n):
    # di = rowsum(dO * O), which the dQ kernel sums in fp32 from the bf16
    # tiles of O and dO and writes for the dK/dV kernel, against the plain
    # version on the same tensors: only the order of 64 terms differs
    q, k, v = _card_qkv(n, cuda_device, seed=13 * n).unbind(2)
    do = _card_qkv(n, cuda_device, seed=17 * n)[:, :, 1]
    o, lse = fa._launch(q, k, v, with_lse=True)
    do, strides = fa._bwd_inputs(q, k, v, o, lse, do)
    dq, di = fa._launch_dq(q, k, v, o, do, lse, strides)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_dq == 1 and fa.flash_attention.launches_dkv == 0
    want = fa.flash_attention_di_ref(o, do)
    assert di.shape == want.shape == (2, 12, n) and di.dtype == torch.float32
    torch.testing.assert_close(di, want, atol=1e-5 * want.abs().max().item(), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [197, 1025])
def test_backward_is_bitwise_repeatable_on_card(cuda_device, n):
    # no atomics: every element of dq, dk and dv is summed by one thread in a
    # fixed order, so two runs on the same inputs give the same bits
    qkv = _card_qkv(n, cuda_device, seed=19 * n)
    q, k, v = qkv.unbind(2)
    do = _card_qkv(n, cuda_device, seed=23 * n)[:, :, 2]
    o, lse = fa._launch(q, k, v, with_lse=True)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_launch_counts_of_both_dtypes_reset_to_zero():
    # one count a kernel and dtype: the bf16 kernels' names, and the same
    # with _f32 for the fp32 kernels (csrc/flash_attention_f32.cu)
    assert set(fa.LAUNCH_COUNTS) == {
        f"launches{part}{suffix}" for part in ("", "_lse", "_dkv", "_dq")
        for suffix in ("", "_f32")}
    fa.flash_attention.launches_f32 = 3
    fa.reset_launches()
    assert all(getattr(fa.flash_attention, n) == 0 for n in fa.LAUNCH_COUNTS)


def test_f32_launch_structure_matches_the_fp32_sources_entry_points():
    # the fp32 libraries take the same FlashLaunch as the bf16 ones and have
    # the entry points the wrapper binds, with the bf16 ones' arguments: the
    # forward in csrc/flash_attention_f32.cu, dQ and dK/dV in
    # csrc/flash_attention_f32_bwd.cu, each library with its size check
    csrc = Path(fa.__file__).parent.parent / "csrc"
    fwd, bwd = ((csrc / f"{name}.cu").read_text() for name in (fa.KERNEL_F32, fa.KERNEL_F32_BWD))
    for src, entries in ((fwd, (("flash_attention_fwd_f32", 5),)),
                         (bwd, (("flash_attention_bwd_dq_f32", 8),
                                ("flash_attention_bwd_dkv_f32", 8)))):
        assert '#include "flash_attention_common.cuh"' in src
        for name, n_ptr in entries:
            sig = re.search(rf'extern "C" int {name}\((.*?)\)', src, re.S).group(1)
            args = [a.strip() for a in sig.split(",")]
            assert len(args) == n_ptr + 2 and args[-2].startswith("const FlashLaunch*")
            assert args[-1] == "void* stream"
    assert "flash_attention_f32_launch_bytes" in fwd
    assert "flash_attention_f32_bwd_launch_bytes" in bwd
    assert "flash_attention_bwd_dq_f32" not in fwd and "flash_attention_fwd_f32" not in bwd
    # both fp32 kernels: tf32 products on wgmma fed by TMA, no atomics, no
    # bf16. The fp32 helpers they share (flash_attention_common.cuh, namespace
    # flash::f32) hold the TMA tile loads and the three-pass products with A
    # from registers; each kernel calls them (the backward also has its
    # products with A in shared memory)
    common = (csrc / "flash_attention_common.cuh").read_text()
    shared = re.sub(r"//.*", "", re.search(r"\nnamespace f32 \{\n(.*)\n\}  // namespace f32",
                                           common, re.S).group(1))
    for used in ("wgmma_tf32_rs", "to_tf32", "tma_load_4d"):
        assert used in shared, used
    calls = ("product3_rs<", "product3_rs_block<", "load_tile<", "to_tf32", "setmaxnreg")
    for src, used_here in ((fwd, calls), (bwd, ("wgmma_tf32_ss", *calls))):
        code = re.sub(r"//.*", "", src)
        for used in used_here:
            assert used in code, used
        for banned in ("atomic", "bf16", "__nv_bfloat16", "mma.sync"):
            assert banned not in code and banned not in shared, banned


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to tf32 as cvt.rna.tf32.f32 rounds it: to nearest,
    ties away from zero, on the low 13 mantissa bits (which end zero)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(passes: int):
    """a @ b of fp32 tensors as tf32 tensor-core products summed in fp32:
    one pass hi(a) hi(b), or three, lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b)
    with lo(x) = tf32(x - hi(x)), the tails before the heads as
    csrc/flash_attention_f32_bwd.cu sums them. A product of two tf32 values
    is exact in fp32."""
    def mm(a, b):
        a_hi, b_hi = _tf32(a), _tf32(b)
        if passes == 1:
            return a_hi @ b_hi
        return (_tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi)) + a_hi @ b_hi
    return mm


def _bwd_with(mm, q, k, v, o, lse, do):
    """flash_attention_bwd_ref with every product taken by mm: (dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (t.transpose(1, 2) for t in (q, k, v, do))
    p = torch.exp(mm(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    dv = mm(p.transpose(-1, -2), dof)
    dp = mm(dof, vf.transpose(-1, -2))
    ds = p * (dp - fa.flash_attention_di_ref(o, do)[..., None])
    dq = mm(ds, kf) * scale
    dk = mm(ds.transpose(-1, -2), qf) * scale
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


def _fwd_with(mm, q, k, v, tile=32):
    """The fp32 forward kernel's arithmetic with every product taken by mm:
    over the kernel's key tiles of `tile` keys, S = Q K^T, the online softmax
    in the log2 domain (running maxima m, sums l, the scale folded into
    log2(e)), each tile's P V summed apart (pv) and taken into O at the next
    tile, O = (O + pv) * alpha; (O + pv) / l at the end."""
    scale_log2 = q.shape[-1] ** -0.5 * math.log2(math.e)
    qf, kf, vf = (t.transpose(1, 2) for t in (q, k, v))
    B, H, N, D = qf.shape
    m = torch.full((B, H, N, 1), -math.inf)
    l, o, pv = torch.zeros((B, H, N, 1)), torch.zeros((B, H, N, D)), torch.zeros((B, H, N, D))
    for key0 in range(0, N, tile):
        s = mm(qf, kf[:, :, key0:key0 + tile].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = (o + pv) * alpha
        pv = mm(p, vf[:, :, key0:key0 + tile])
        m = m_new
    return ((o + pv) / l).transpose(1, 2)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -1.0 - 2.0 ** -11,
                      3.0 * 2.0 ** -11 + 1.0, 1e-30, 0.0])
    got = _tf32(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -1.0 - 2.0 ** -10,
                         1.0 + 2.0 ** -9, _tf32(torch.tensor([1e-30])).item(), 0.0])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    assert ((_tf32(r) - r).abs() <= 2.0 ** -11 * r.abs()).all()
    lo = _tf32(r - _tf32(r))  # the tail: head + tail within 2^-22 of r
    assert ((_tf32(r) + lo - r).abs() <= 2.0 ** -22 * r.abs()).all()


@pytest.mark.parametrize("n", [65, 197])
def test_three_pass_tf32_backward_meets_the_fp32_contract(n):
    # the CPU witness of csrc/flash_attention_f32_bwd.cu's arithmetic: every
    # product of flash_attention_bwd_ref as three TF32 passes, held to the fp32
    # plain backward within F32_BWD_RTOL = 2^-12 of each gradient's max|ref|,
    # the card tests' tolerance. One pass (tf32 heads only) is reported beside
    # it: it misses the three passes' error by orders of magnitude
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, n, 2, 64), seed=70 + n))
    do = torch.from_numpy(_qkv((1, n, 2, 64), seed=80 + n)[0])
    o, lse = fa.flash_attention_ref(q, k, v), fa.flash_attention_lse_ref(q, k)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    three = _bwd_with(_mm_tf32(3), q, k, v, o, lse, do)
    one = _bwd_with(_mm_tf32(1), q, k, v, o, lse, do)
    for name, w, g3, g1 in zip(("dq", "dk", "dv"), want, three, one):
        ref = w.abs().max().item()
        e3, e1 = ((g - w).abs().max().item() / ref for g in (g3, g1))
        print(f"N={n} {name}: max|d| / max|ref| three passes {e3:.2e}, one pass {e1:.2e}, "
              f"tolerance {F32_BWD_RTOL:.2e}")
        assert e3 <= F32_BWD_RTOL, f"{name}: {e3}"
        assert e1 > 16 * e3, f"{name}: one pass {e1} vs three {e3}"


@pytest.mark.parametrize("n", [65, 197])
def test_three_pass_tf32_forward_meets_the_fp32_contract(jax_flash_attention, n):
    # the CPU witness of csrc/flash_attention_f32.cu's arithmetic: S = Q K^T and
    # P V as three TF32 passes each, the online softmax over the kernel's
    # 32-key tiles, held within F32_RTOL = 2^-14 of max|ref| of the plain
    # version and of the JAX Pallas kernel (interpret mode), the card tests'
    # tolerance. One pass (tf32 heads only) misses that tolerance
    q, k, v = _qkv((1, n, 2, 64), seed=90 + n)
    want = fa.flash_attention_ref(*map(torch.from_numpy, (q, k, v)))
    jax_out = torch.from_numpy(np.array(jax_flash_attention(q, k, v)))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    three, one = (_fwd_with(_mm_tf32(p), qt, kt, vt) for p in (3, 1))
    tol = F32_RTOL * want.abs().max().item()
    e3, e3_jax, e1 = ((a - b).abs().max().item()
                      for a, b in ((three, want), (three, jax_out), (one, want)))
    print(f"N={n}: max|d| three passes {e3:.2e} (vs JAX {e3_jax:.2e}), one pass {e1:.2e}, "
          f"tolerance {tol:.2e}")
    assert e3 <= tol and e3_jax <= tol, (e3, e3_jax)
    assert e1 > tol, e1


# fp32 kernels against the fp32 plain version on the card, with TF32 off
# for the plain version's matmuls: at most 2^-14 of max|ref| for the output
# and 2^-12 for each gradient (one TF32 pass, unit roundoff 2^-11, cannot
# meet them; the backward's three passes keep ~21 bits, see
# test_three_pass_tf32_backward_meets_the_fp32_contract)
F32_RTOL, F32_BWD_RTOL = 2.0 ** -14, 2.0 ** -12


@pytest.fixture
def fp32_reference(cuda_device):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.get_float32_matmul_precision() == "highest"
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _card_qkv32(n, device, seed, heads=12, batch=2):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, 3, heads, 64)).astype(np.float32)
    return torch.from_numpy(a).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 129, 197, 577, 1025])
def test_f32_forward_matches_plain_version_on_card(cuda_device, fp32_reference, launches, n,
                                                    with_lse):
    # q, k, v strided out of one fused fp32 tensor, every ragged tail against
    # the 64-row tiles; lse against logsumexp of the fp32 scores (1e-5: both
    # fp32, only the order of the sums differs)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    q, k, v = _card_qkv32(n, cuda_device, seed=31 * n).unbind(2)
    out, lse = fa._launch(q, k, v, with_lse=with_lse)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_f32, fa.flash_attention.launches_lse_f32,
            fa.flash_attention.launches) == (1, int(with_lse), 0)
    ref = fa.flash_attention_ref(q, k, v)
    assert out.dtype == torch.float32 and out.is_contiguous() and out.shape == q.shape
    err = (out - ref).abs().max().item()
    assert err <= F32_RTOL * ref.abs().max().item(), f"max|d| {err}"
    if with_lse:
        torch.testing.assert_close(lse, fa.flash_attention_lse_ref(q, k), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0x7FFFFFFF, -1], ids=["nan", "negative_nan"])
@pytest.mark.parametrize("which", [0, 1, 2], ids=["q", "k", "v"])
def test_f32_kernels_carry_a_nan_input_on_card(cuda_device, fp32_reference, launches, which,
                                               bits):
    # the GPU's NaN (0x7fffffff) or its negation (0xffffffff) in one element
    # of q, k or v: the forward is NaN exactly where the plain version is, and
    # each gradient holds a NaN where the plain backward's does. The kernels
    # round the tf32 tails and P by integer operations that can turn these
    # NaNs into zeros; the heads (cvt.rna) and the softmax sums carry them
    qkv = _card_qkv32(197, cuda_device, seed=79)
    qkv.view(torch.int32)[1, 150, which, 3, 17] = bits
    qkv.requires_grad_()
    q, k, v = qkv.unbind(2)
    g = _card_qkv32(197, cuda_device, seed=83)[:, :, 0]
    out = fa.flash_attention(q, k, v)
    out.backward(g)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_f32 == 1 and fa.flash_attention.launches_dq_f32 == 1
    qd, kd, vd = (t.detach() for t in (q, k, v))
    want = fa.flash_attention_ref(qd, kd, vd)
    assert torch.isnan(want).any()
    assert torch.equal(torch.isnan(out.detach()), torch.isnan(want))
    grads = fa.flash_attention_bwd_ref(qd, kd, vd, want, fa.flash_attention_lse_ref(qd, kd), g)
    for name, got, w in zip("qkv", qkv.grad.unbind(2), grads):
        assert bool(torch.isnan(got).any()) == bool(torch.isnan(w).any()), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", BWD_CARD_N)
def test_f32_backward_kernels_match_plain_version_on_card(cuda_device, fp32_reference, launches,
                                                          n):
    # autograd through the fused fp32 view: one launch of each fp32 kernel
    # and none of the bf16 ones; each gradient within 2^-12 of its max|ref|
    # (+1e-6 for dq at N = 1, which vanishes)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    qkv = _card_qkv32(n, cuda_device, seed=37 * n).requires_grad_()
    q, k, v = qkv.unbind(2)
    g = _card_qkv32(n, cuda_device, seed=41 * n)[:, :, 0]
    fa.flash_attention(q, k, v).backward(g)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_f32, fa.flash_attention.launches_lse_f32,
            fa.flash_attention.launches_dq_f32, fa.flash_attention.launches_dkv_f32) == (1, 1, 1, 1)
    assert (fa.flash_attention.launches, fa.flash_attention.launches_dq) == (0, 0)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    want = fa.flash_attention_bwd_ref(qd, kd, vd, fa.flash_attention_ref(qd, kd, vd),
                                      fa.flash_attention_lse_ref(qd, kd), g)
    for name, got, w in zip("qkv", qkv.grad.unbind(2), want):
        err = (got - w).abs().max().item()
        assert err <= F32_BWD_RTOL * w.abs().max().item() + 1e-6, f"d{name}: max|d| {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", BWD_CARD_N)
def test_f32_backward_reads_a_do_strided_apart_on_card(cuda_device, fp32_reference, launches, n):
    # the fp32 backward kernels read q, k, v strided out of one fused tensor
    # and dO, a heads-first [B, H, N, D] tensor seen as [B, N, H, D], through
    # tensor maps of their own strides, in place; each gradient within 2^-12
    # of its max|ref| (+1e-6 for dq at N = 1, which vanishes)
    q, k, v = _card_qkv32(n, cuda_device, seed=71 * n).unbind(2)
    do = _card_qkv32(n, cuda_device, seed=73 * n)[:, :, 1].permute(0, 2, 1, 3).contiguous()
    do = do.transpose(1, 2)
    assert do.stride() != q.stride()
    o, lse = fa._launch(q, k, v, with_lse=True)
    assert fa._bwd_inputs(q, k, v, o, lse, do)[0] is do  # read in place
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_dq_f32, fa.flash_attention.launches_dkv_f32) == (1, 1)
    want = fa.flash_attention_bwd_ref(q, k, v, fa.flash_attention_ref(q, k, v),
                                      fa.flash_attention_lse_ref(q, k), do)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        err = (got - w).abs().max().item()
        assert err <= F32_BWD_RTOL * w.abs().max().item() + 1e-6, f"{name}: max|d| {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 197, 1025])
def test_f32_dq_kernel_writes_di_on_card(cuda_device, launches, n):
    q, k, v = _card_qkv32(n, cuda_device, seed=43 * n).unbind(2)
    do = _card_qkv32(n, cuda_device, seed=47 * n)[:, :, 1]
    o, lse = fa._launch(q, k, v, with_lse=True)
    do, strides = fa._bwd_inputs(q, k, v, o, lse, do)
    dq, di = fa._launch_dq(q, k, v, o, do, lse, strides)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_dq_f32 == 1 and fa.flash_attention.launches_dkv_f32 == 0
    want = fa.flash_attention_di_ref(o, do)
    torch.testing.assert_close(di, want, atol=1e-5 * want.abs().max().item(), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [197, 1025])
def test_f32_kernels_are_bitwise_repeatable_on_card(cuda_device, n):
    # no atomics: every output element is summed by one thread in a fixed order
    q, k, v = _card_qkv32(n, cuda_device, seed=53 * n).unbind(2)
    do = _card_qkv32(n, cuda_device, seed=59 * n)[:, :, 2]
    runs = []
    for _ in range(2):
        o, lse = fa._launch(q, k, v, with_lse=True)
        runs.append((o, lse, *fa.flash_attention_bwd(q, k, v, o, lse, do)))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_f32_kernels_launch_once_each_under_a_cuda_graph(cuda_device, launches):
    # captured forward + backward: one launch of each fp32 kernel at capture,
    # replays that reproduce the eager results bitwise
    qkv = _card_qkv32(197, cuda_device, seed=61).requires_grad_()
    g = _card_qkv32(197, cuda_device, seed=67)[:, :, 0]

    def step():
        qkv.grad = None
        fa.flash_attention(*qkv.unbind(2)).backward(g)
        return qkv.grad

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = step().clone()  # warm-up on a side stream, as engine/compiled.py does
    torch.cuda.current_stream().wait_stream(stream)
    fa.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    assert (fa.flash_attention.launches_f32, fa.flash_attention.launches_dq_f32,
            fa.flash_attention.launches_dkv_f32) == (1, 1, 1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    assert fa.flash_attention.launches_f32 == 1  # a replay runs no Python


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operators_fake_versions_keep_the_dtype(dtype):
    # torch.export traces the operators with fake tensors: the fake forward
    # and backward give outputs of the inputs' dtype (lse fp32), so an
    # exported fp32 model records the fp32 kernels' operators as a bf16 one
    # records the bf16 ones; nothing launches
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty((2, 9, 3, 64), dtype=dtype)
        out, lse = fa._fwd_op(q, q, q, True)
        grads = fa._bwd_op(q, q, q, out, lse, out)
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, 9)
    assert all(g.dtype == dtype and g.shape == q.shape for g in grads)
