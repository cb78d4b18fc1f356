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


def _cta_tiles(plan, rows, cta):
    """The rows CTA `cta` of `plan` normalises, as csrc/layernorm.cu
    `walk_tiles` walks them (tiles cta, cta + ctas, ...): a range of rows for
    each tile, each one bulk copy (a tensor's) of len(range) * C * itemsize
    bytes."""
    tiles = -(-rows // plan.tile_rows)
    return [range(t * plan.tile_rows, min(rows, (t + 1) * plan.tile_rows))
            for t in range(cta, tiles, plan.ctas)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("C", [8, 96, 192, 384, 768, 4096])
def test_ln_plan_fits_and_covers_every_row_once(C, itemsize, backward):
    # what the bulk kernels' launch checks, and the walk they make: the
    # lanes of a row hold its vectors (no more vectors a lane than needed),
    # tiles of whole row slots, a ring of 2-4 stages (and the backward's
    # column sums) within 227 KB, two CTAs an SM where the plan says so;
    # every row normalised exactly once over the CTAs, the last tile
    # ragged, each bulk copy a multiple of 16 bytes
    vec = 16 // itemsize
    slots_of = lambda p: ln.LN_THREADS // p.lanes  # noqa: E731
    one = ln.ln_plan(1, C, itemsize, backward)
    rows = 3 * one.tile_rows * ln.H100_SMS + 5  # more tiles than CTAs, ragged
    plan = ln.ln_plan(rows, C, itemsize, backward)
    assert plan[:7] == one[:7]  # the layout does not depend on the row count
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= ln.LN_THREADS
    assert 1 <= plan.vecs <= ln.LN_MAX_VECS
    assert (plan.vecs - 1) * plan.lanes < C // vec <= plan.vecs * plan.lanes
    assert plan.tile_rows % slots_of(plan) == 0
    assert 2 <= plan.stages <= ln.LN_STAGES
    assert plan.x_bytes % 128 == 0 and plan.x_bytes >= plan.tile_rows * C * itemsize
    assert plan.stage_bytes == (2 if backward else 1) * plan.x_bytes
    assert plan.smem_bytes >= plan.stages * plan.stage_bytes + 128
    if backward:
        assert plan.smem_bytes >= slots_of(plan) * 2 * C * 4 + 128
    assert plan.smem_bytes <= ln.LN_SMEM_MAX <= 227 * 1024
    per_sm = -(-plan.ctas // ln.H100_SMS)
    assert per_sm <= (ln.LN_BWD_CTAS_PER_SM if backward else ln.LN_FWD_CTAS_PER_SM)
    assert per_sm * (plan.smem_bytes + ln.LN_CTA_OVERHEAD) <= ln.SMEM_PER_SM
    seen = np.zeros(rows, np.int64)
    for cta in range(plan.ctas):
        tiles = _cta_tiles(plan, rows, cta)
        assert tiles, "every CTA normalises at least one tile"
        for r in tiles:
            assert 0 < len(r) <= plan.tile_rows and len(r) * C * itemsize % 16 == 0
            seen[r.start:r.stop] += 1
    assert (seen == 1).all()
    assert plan.tile_rows == 1 or rows % plan.tile_rows  # a ragged last tile


@pytest.mark.parametrize("rows", [1, 1000, 10 ** 6])
def test_ln_plan_takes_the_warp_path_off_the_vector_width(rows):
    # C = 100 in bf16 is not a multiple of 8: no bulk plan, only the
    # backward's grid, a CTA per 8 rows up to two an SM; fp32 (a multiple of
    # 4: 25 vectors) takes the bulk path, 8 lanes of up to 4 vectors
    plan = ln.ln_plan(rows, 100, 2, True)
    assert plan.lanes == 0 and 1 <= plan.ctas <= min(-(-rows // 8), 2 * ln.H100_SMS)
    assert ln.ln_plan(rows, 100, 4, True)[:2] == (8, 4)


def _no_grad_and_gamma_only(device, dtype):
    """y without grad mode, with it, and with only gamma requiring a
    gradient, held bitwise equal; the gradients of all three inputs and of
    gamma alone held bitwise equal; a second backward held to twice the first
    (it accumulates into the gradients the first left: on the card dgamma
    and dbeta come back as the two rows of one tensor). Returns (y, the
    gradients of x, gamma, beta, the plain version's (dx, dgamma, dbeta))."""
    x, g, b = (torch.from_numpy(a).to(device) for a in _inputs((3, 5, 96), seed=11))
    x = x.to(dtype)
    t = torch.from_numpy(np.random.default_rng(12).standard_normal(x.shape).astype(np.float32))
    t = t.to(device)
    with torch.no_grad():
        y0 = ln.fused_layer_norm(x.requires_grad_(), g.requires_grad_(), b.requires_grad_())
    assert y0.grad_fn is None
    x.grad = g.grad = b.grad = None
    y1 = ln.fused_layer_norm(x, g, b)
    assert y1.grad_fn is not None
    assert torch.equal(y1, y0)
    (y1.float() * t).sum().backward()
    full = tuple(v.grad.clone() for v in (x, g, b))
    gamma = g.detach().clone().requires_grad_()
    y2 = ln.fused_layer_norm(x.detach(), gamma, b.detach())
    assert torch.equal(y2, y0)
    (y2.float() * t).sum().backward()
    assert torch.equal(gamma.grad, full[1])
    (ln.fused_layer_norm(x, g, b).float() * t).sum().backward()
    for v, first in zip((x, g, b), full):
        assert torch.equal(v.grad, 2 * first)
    return y0, full, ln.layer_norm_bwd_ref(x.detach(), g.detach(), t.to(dtype), 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_grad_and_gamma_only_give_the_same_values_and_gradients(dtype):
    # the wrapper builds an autograd node only when an input needs a
    # gradient: the values are the same either way, and a gradient of gamma
    # alone is the one it gets when every input requires one
    _, full, want = _no_grad_and_gamma_only("cpu", dtype)
    for got, w in zip(full, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


# rows x C on the card: the ConvNeXt-T stage widths at small row counts, a
# ragged ViT row count, a C that is not a multiple of the vector width (bf16:
# the warp-per-row kernels), wide rows over several warps (2048, 4096), and
# row counts against the tiles of the bulk path (bf16 / fp32: 80 / 40 rows
# at C = 96, 8 / 4 at C = 768): fewer rows than a tile (7x96, 3x768), one
# tile exactly (80x96, 8x768), a ragged last tile (247x96, 43x768), and more
# tiles than CTAs, so the rings wrap (30011x96, 3001x768)
CARD_SHAPES = [(7, 96), (2 * 197, 768), (1000, 192), (33, 100), (64, 768), (9, 4096),
               (4100, 384), (80, 96), (247, 96), (30011, 96), (3, 768), (8, 768), (43, 768),
               (3001, 768), (5, 2048), (17, 1000)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200704, 96), (12608, 768)])
def test_backward_is_bitwise_repeatable_at_model_shapes_on_card(cuda_device, shape):
    # ConvNeXt-T's stage 0 and ViT-B/16's token rows at batch 64, bf16:
    # dgamma/dbeta sum every row in a fixed order, so three runs give the
    # same bits (and so do dx and y)
    x, g, b = (torch.from_numpy(a).to(cuda_device) for a in _inputs(shape, seed=13))
    x = x.bfloat16()
    dy = torch.randn(shape, device=cuda_device).bfloat16()
    runs = [(ln.fused_layer_norm(x, g, b), *ln.layer_norm_bwd(x, g, dy)) for _ in range(3)]
    for run in runs[1:]:
        for a, c in zip(runs[0], run):
            assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3136, 768), (33, 100)])
def test_one_launch_a_forward_and_one_plus_the_sums_a_backward_on_card(cuda_device, launches,
                                                                       shape):
    # the counters and a trace agree: a forward is one kernel, a backward one
    # kernel and one partial-sum pass, and nothing else runs on the card
    from torch.profiler import ProfilerActivity, profile

    x, g, b = (torch.from_numpy(a).to(cuda_device) for a in _inputs(shape, seed=14))
    x = x.bfloat16()
    dy = torch.randn(shape, device=cuda_device).bfloat16()
    ln.fused_layer_norm(x, g, b)
    ln.layer_norm_bwd(x, g, dy)
    torch.cuda.synchronize()
    for call, want in ((lambda: ln.fused_layer_norm(x, g, b), ["layer_norm_fwd"]),
                       (lambda: ln.layer_norm_bwd(x, g, dy), ["layer_norm_bwd", "sum_partials"])):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = sorted(e.name for e in prof.events() if e.device_type.name == "CUDA")
        assert len(names) == len(want), names
        for name, w in zip(names, want):
            assert w in name, names
    assert (ln.fused_layer_norm.launches, ln.fused_layer_norm.launches_bwd) == (2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_grad_and_gamma_only_give_the_same_values_and_gradients_on_card(cuda_device,
                                                                           launches, dtype):
    # the kernels' side of the CPU test above: the branch without an
    # autograd node and the backward through it (dgamma and dbeta the views
    # of one [2, C] tensor, accumulated into by a second backward), against
    # the plain versions at the tolerances of the tests above
    y, full, want = _no_grad_and_gamma_only(cuda_device, dtype)
    assert (ln.fused_layer_norm.launches, ln.fused_layer_norm.launches_bwd) == (4, 3)
    x, g, b = (torch.from_numpy(a).to(cuda_device) for a in _inputs((3, 5, 96), seed=11))
    want_y = ln.layer_norm_ref(x.to(dtype), g, b)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert (y.float() - want_y.float()).abs().max().item() <= rel * want_y.float().abs().max().item()
    for name, got, w, r in zip(("dx", "dgamma", "dbeta"), full, want, (rel, 1e-4, 1e-4)):
        assert got.dtype == w.dtype, name
        err = (got.float() - w.float()).abs().max().item()
        assert err <= r * w.float().abs().max().item(), f"{name}: max|d| {err}"
