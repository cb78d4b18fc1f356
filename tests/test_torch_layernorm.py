"""Port fused LayerNorm (imageclassification_tpu_torch/ops/layernorm.py)
against the JAX package's `fused_layer_norm`: its Pallas kernels (`_fused`,
forward and custom-VJP backward) run in interpret mode on the CPU, with
`supported` patched to take the kernel path off the TPU, the way
tests/test_pallas_layernorm.py runs them. On the CPU the port's wrapper takes
its plain versions; the CUDA kernels are checked by the `cuda` tests on a card
(and by chip_smoke.py). JAX is imported inside the tests that use it, so the
`cuda` tests of this file also run where JAX is absent:

    python -m pytest --noconftest tests/test_torch_layernorm.py -m cuda
"""

import numpy as np
import pytest
import torch

from imageclassification_tpu_torch.ops import layernorm as ln


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_ln(monkeypatch):
    """f(x, gamma, beta) -> the JAX `_fused` Pallas LayerNorm on x viewed as
    [rows, C], kernels in interpret mode."""
    import jax.experimental.pallas as pl

    from imageclassification_tpu.ops import pallas_layernorm as pln

    orig = pl.pallas_call
    monkeypatch.setattr(pln.pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(pln, "supported", lambda shape, backend=None: pln._pick_rows(
        int(np.prod(shape[:-1])), shape[-1]))

    def run(x, g, b, eps=1e-6):
        rows = pln.supported(x.shape)
        assert rows > 0
        return pln._fused(x.reshape(-1, x.shape[-1]), g, b, eps, rows).reshape(x.shape)

    return run


@pytest.fixture
def launches(monkeypatch):
    for name in ("launches", "launches_bwd"):
        monkeypatch.setattr(ln.fused_layer_norm, name, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the LayerNorm kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(shape, seed, x_std=2.0):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    return (rng.normal(0.5, x_std, shape).astype(np.float32),
            rng.normal(1, 0.2, (C,)).astype(np.float32),
            rng.normal(0, 0.2, (C,)).astype(np.float32))


def test_forward_matches_pallas_kernel(pallas_ln):
    # fp32, the same formula (E[x^2] - E[x]^2); summation order only: 2e-5,
    # the tolerance of tests/test_pallas_layernorm.py
    import jax.numpy as jnp

    x, g, b = _inputs((4, 8, 8, 96), seed=0)
    want = np.asarray(pallas_ln(*map(jnp.asarray, (x, g, b))))
    got = ln.fused_layer_norm(*map(torch.from_numpy, (x, g, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_gradients_match_pallas_kernel(pallas_ln):
    # jax.grad through the Pallas backward kernel against torch autograd
    # through the port's CPU path (`layer_norm_bwd_ref`); fp32, 2e-4 as in
    # tests/test_pallas_layernorm.py (dgamma/dbeta sum 32 rows)
    import jax
    import jax.numpy as jnp

    x, g, b = _inputs((2, 4, 4, 64), seed=1, x_std=1.0)
    t = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda x, g, b: jnp.sum(pallas_ln(x, g, b) * t), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, g, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    (ln.fused_layer_norm(*leaves) * torch.from_numpy(t)).sum().backward()
    for name, leaf, w in zip(("dx", "dgamma", "dbeta"), leaves, want):
        assert np.abs(np.asarray(w)).max() > 0.1
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_bf16_output_dtype_matches_pallas_kernel(pallas_ln):
    # bf16 x, fp32 gamma/beta: the output is bf16 on both sides; fp32 inside,
    # so the two agree to one bf16 rounding of values up to ~4: 2^-6
    import jax.numpy as jnp

    x, g, b = _inputs((2, 8, 128), seed=2, x_std=1.0)
    xb = torch.from_numpy(x).bfloat16()
    got = ln.fused_layer_norm(xb, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    want = pallas_ln(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(g), jnp.asarray(b))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2.0 ** -6,
                               rtol=0)


def test_ragged_rows_match_jax_reference():
    # 2 * 197 rows (ViT tokens at batch 2): no Pallas row block divides it
    # (the JAX function falls back to jnp), the port's op takes it; fp32
    # against the JAX `layer_norm_ref` and jax.grad of it: 2e-5 and 2e-4
    import jax
    import jax.numpy as jnp

    from imageclassification_tpu.ops import pallas_layernorm as pln

    assert pln._pick_rows(2 * 197, 192) == 0
    x, g, b = _inputs((2, 197, 192), seed=3)
    np.testing.assert_allclose(
        ln.fused_layer_norm(*map(torch.from_numpy, (x, g, b))).numpy(),
        np.asarray(pln.layer_norm_ref(*map(jnp.asarray, (x, g, b)))), rtol=2e-5, atol=2e-5)
    t = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(pln.layer_norm_ref(*a) * t), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, g, b)))
    got = ln.layer_norm_bwd(*map(torch.from_numpy, (x, g, t)))
    for name, gt, w in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4, err_msg=name)


def test_constant_row_gives_beta():
    # var = E[x^2] - E[x]^2 is exactly 0 for a row of one value that sums
    # exactly (not clamped, eps added as in the JAX reference); rstd =
    # 1/sqrt(eps), x - mean = 0, so y = beta, xhat = 0, dgamma = 0 and
    # dx = rstd (dy gamma - mean(dy gamma))
    x = torch.full((3, 96), 0.75)
    g, b = torch.linspace(0.5, 1.5, 96), torch.linspace(-1, 1, 96)
    torch.testing.assert_close(ln.layer_norm_ref(x, g, b), b.expand(3, 96), rtol=0, atol=0)
    dx, dg, db = ln.layer_norm_bwd_ref(x, g, torch.ones_like(x))
    torch.testing.assert_close(dx, (1e-6 ** -0.5 * (g - g.mean())).expand(3, 96), rtol=1e-5,
                               atol=1e-3)
    assert torch.all(dg == 0) and torch.all(db == 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_takes_plain_version_and_launches_nothing(launches, dtype):
    x, g, b = (torch.from_numpy(a) for a in _inputs((5, 7, 96), seed=5))
    x = x.to(dtype).requires_grad_()
    y = ln.fused_layer_norm(x, g, b)
    assert y.dtype == dtype
    torch.testing.assert_close(y, ln.layer_norm_ref(x, g, b), rtol=0, atol=0)
    y.float().square().sum().backward()
    assert x.grad.dtype == dtype and torch.isfinite(x.grad.float()).all()
    assert (ln.fused_layer_norm.launches, ln.fused_layer_norm.launches_bwd) == (0, 0)


@pytest.mark.parametrize("dtype,C,err", [
    (torch.float16, 96, NotImplementedError),   # dtype gap
    (torch.float32, 8192, NotImplementedError),  # C > 4096, as the Pallas _MAX_C
    (torch.bfloat16, 4096, None),
    (torch.float32, 100, None),                   # not a multiple of the vector width
])
def test_kernel_input_checks(dtype, C, err):
    x = torch.zeros((3, C), dtype=dtype)
    g = torch.ones(C)
    if err is None:
        ln.check_kernel_inputs(x, g, g)
    else:
        with pytest.raises(err):
            ln.check_kernel_inputs(x, g, g)
    with pytest.raises(ValueError):
        ln.check_kernel_inputs(torch.zeros((3, 96)), torch.ones(95), torch.ones(96))


# rows x C on the card: the ConvNeXt-T stage widths at small row counts, a
# ragged ViT row count, a C that is not a multiple of the vector width, and
# the largest C (the backward's 4-warp, 128 KB shared-memory path)
CARD_SHAPES = [(7, 96), (2 * 197, 768), (1000, 192), (33, 100), (64, 768), (9, 4096),
               (4100, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_version_on_card(cuda_device, launches, shape, dtype):
    x, g, b = (torch.from_numpy(a).to(cuda_device) for a in _inputs(shape, seed=shape[0]))
    x = x.to(dtype)
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    dy = dy.to(cuda_device, dtype)
    y = ln.fused_layer_norm(x, g, b)
    dx, dg, db = ln.layer_norm_bwd(x, g, dy)
    torch.cuda.synchronize()
    assert (ln.fused_layer_norm.launches, ln.fused_layer_norm.launches_bwd) == (1, 1)
    want_y = ln.layer_norm_ref(x, g, b)
    want = ln.layer_norm_bwd_ref(x.float(), g, dy.float())
    # fp32: summation order only (1e-5 of the largest value; dgamma/dbeta sum
    # up to 4100 rows in another order, 1e-4); bf16 outputs: one rounding,
    # 2^-7 of the largest value
    tol_y = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * want_y.float().abs().max().item()
    assert (y.float() - want_y.float()).abs().max().item() <= tol_y
    for name, got, w, rel in (("dx", dx, want[0], 1e-5 if dtype == torch.float32 else 2.0 ** -7),
                              ("dgamma", dg, want[1], 1e-4), ("dbeta", db, want[2], 1e-4)):
        tol = rel * w.abs().max().item()
        err = (got.float() - w).abs().max().item()
        assert err <= tol, f"{name}: max|d| {err} > {tol}"


@pytest.mark.cuda
def test_backward_is_deterministic_and_takes_constant_rows_on_card(cuda_device):
    x = torch.full((300, 96), 0.75, device=cuda_device)
    x[1::2] = torch.randn((150, 96), device=cuda_device)
    g = torch.linspace(0.5, 1.5, 96, device=cuda_device)
    b = torch.linspace(-1, 1, 96, device=cuda_device)
    y = ln.fused_layer_norm(x, g, b)
    assert torch.equal(y[::2], b.expand(150, 96))  # constant rows give beta
    dy = torch.randn_like(x)
    first = ln.layer_norm_bwd(x, g, dy)
    for _ in range(3):
        for a, c in zip(first, ln.layer_norm_bwd(x, g, dy)):
            assert torch.equal(a, c)  # no atomics: the same bits every run
