"""Port 7x7 depthwise conv (imageclassification_tpu_torch/ops/dwconv.py)
against the JAX package's `depthwise_conv7x7`, whose Pallas kernel runs in
interpret mode on the CPU (as tests/test_pallas_dwconv.py runs it), and
against its `dwconv7x7_reference` (lax.conv). On the CPU the port's wrapper
takes its plain versions; the CUDA kernels are checked by the `cuda` tests on
a card (and by chip_smoke.py). JAX is imported inside the tests that use it,
so the `cuda` tests of this file also run where JAX is absent:

    python -m pytest --noconftest tests/test_torch_dwconv.py -m cuda
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imageclassification_tpu_torch.ops import dwconv


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_dw(monkeypatch):
    """The JAX pallas_dwconv module, its kernel in interpret mode."""
    import jax.experimental.pallas as pl

    from imageclassification_tpu.ops import pallas_dwconv as dw

    orig = pl.pallas_call
    monkeypatch.setattr(dw.pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    return dw


@pytest.fixture
def launches(monkeypatch):
    for name in ("launches", "launches_dx", "launches_dw"):
        monkeypatch.setattr(dwconv.depthwise_conv7x7, name, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the depthwise-conv kernels have no CPU mode")
    return torch.device("cuda")


def _xw(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (0.2 * rng.standard_normal((7, 7, shape[-1]))).astype(np.float32))


def test_forward_matches_pallas_kernel_and_lax(pallas_dw):
    # H != W (12 x 10); fp32, 49-term sums in another order: 1e-5
    import jax.numpy as jnp

    x, w = _xw((2, 12, 10, 8), seed=0)
    got = dwconv.depthwise_conv7x7(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    for want in (pallas_dw.depthwise_conv7x7(jnp.asarray(x), jnp.asarray(w)),
                 pallas_dw.dwconv7x7_reference(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (2, 12, 10, 8)])
def test_gradients_match_pallas_kernel(pallas_dw, shape):
    # jax.grad through the Pallas VJP (dx: the kernel on the padded gradient
    # with the flipped weights; dw: XLA's 49 reductions) against torch
    # autograd through the port's CPU path; fp32: 1e-4
    import jax
    import jax.numpy as jnp

    x, w = _xw(shape, seed=1)
    want = jax.grad(lambda x, w: jnp.sum(pallas_dw.depthwise_conv7x7(x, w) ** 2),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    (dwconv.depthwise_conv7x7(tx, tw) ** 2).sum().backward()
    for name, got, wt in (("dx", tx.grad, want[0]), ("dw", tw.grad, want[1])):
        assert np.abs(np.asarray(wt)).max() > 0.1
        np.testing.assert_allclose(got.numpy(), np.asarray(wt), rtol=1e-4, atol=1e-4, err_msg=name)


def test_bf16_io_matches_pallas_kernel(pallas_dw):
    # bf16 in and out, fp32 accumulation on both sides: the outputs agree to
    # one bf16 rounding of values up to ~4 (2^-6), and dx, dw come back in
    # the dtypes of x and w
    import jax.numpy as jnp

    x, w = _xw((1, 8, 8, 8), seed=2)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = dwconv.depthwise_conv7x7(xb, wb)
    assert got.dtype == torch.bfloat16
    want = pallas_dw.depthwise_conv7x7(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                       jnp.asarray(wb.float().numpy(), jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2.0 ** -6,
                               rtol=0)
    dx, dw = dwconv.dwconv7x7_bwd(xb, torch.from_numpy(w), torch.ones_like(xb))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32


def test_flip_is_spatial_only():
    # the input gradient is the forward on dy with w flipped in (ky, kx), not
    # in channels: compare with autograd of the library conv
    x, w = (torch.from_numpy(a) for a in _xw((2, 9, 11, 16), seed=3))
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(x.shape).astype(np.float32))
    xr = x.clone().requires_grad_()
    ref = F.conv2d(xr.permute(0, 3, 1, 2), w.permute(2, 0, 1)[:, None], padding=3, groups=16)
    ref.permute(0, 2, 3, 1).backward(dy)
    dx, dw = dwconv.dwconv7x7_bwd(x, w, dy)
    torch.testing.assert_close(dx, xr.grad, rtol=1e-5, atol=1e-5)
    assert (dwconv.dwconv7x7_ref(dy, w.flip(2), flip=True) - xr.grad).abs().max() > 0.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_takes_plain_version_and_launches_nothing(launches, dtype):
    x, w = (torch.from_numpy(a).to(dtype).requires_grad_() for a in _xw((2, 7, 7, 24), seed=5))
    y = dwconv.depthwise_conv7x7(x, w)
    assert y.dtype == dtype
    torch.testing.assert_close(y, dwconv.dwconv7x7_ref(x, w), rtol=0, atol=0)
    y.float().square().sum().backward()
    assert x.grad.dtype == w.grad.dtype == dtype
    assert (dwconv.depthwise_conv7x7.launches, dwconv.depthwise_conv7x7.launches_dx,
            dwconv.depthwise_conv7x7.launches_dw) == (0, 0, 0)


@pytest.mark.parametrize("dtype,C,err", [
    (torch.float16, 96, NotImplementedError),   # dtype gap
    (torch.bfloat16, 36, NotImplementedError),  # C not a multiple of 8
    (torch.bfloat16, 40, None),                 # convnext_atto stage 0: ragged channel tile
    (torch.float32, 96, None),
])
def test_kernel_input_checks(dtype, C, err):
    x = torch.zeros((1, 4, 4, C), dtype=dtype)
    if err is None:
        dwconv.check_kernel_inputs(x, (7, 7, C), torch.float32)
    else:
        with pytest.raises(err):
            dwconv.check_kernel_inputs(x, (7, 7, C), torch.float32)
    with pytest.raises(ValueError):
        dwconv.check_kernel_inputs(torch.zeros((1, 4, 4, 8)), (3, 3, 8), torch.float32)


@pytest.mark.parametrize("hw", [7, 13, 14, 28, 56])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_dw_plan_covers_every_pixel_once(hw, itemsize):
    # the weight-gradient kernel's items, as it indexes them, cover every
    # (batch, row, column, channel) exactly once over all CTAs (slot, tile)
    B, C = 3, 40  # three channel tiles, the last one ragged
    plan = dwconv.dw_plan(B, hw, hw, C, itemsize)
    seen = np.zeros((B, hw, hw, C), np.int64)
    for tile in range(plan.tiles):
        for slot in range(plan.slots):
            work = dwconv.dw_cta_work(plan, hw, hw, C, slot, tile)
            assert work, "every CTA sums at least one item"
            for b, rows, cols, chans in work:
                assert len(rows) <= dwconv.DW_ROWS and len(cols) <= plan.seg
                seen[b, rows.start:rows.stop, cols.start:cols.stop, chans.start:chans.stop] += 1
    assert (seen == 1).all()
    assert plan.seg % 7 == 0 and plan.seg <= dwconv.DW_SEGMENT


@pytest.mark.parametrize("shape", [(64, 56, 56, 96), (64, 28, 28, 192), (64, 14, 14, 384),
                                   (64, 7, 7, 768), (2, 224, 224, 8)])
def test_dw_plan_fits_the_ctas_of_an_sm(shape):
    # ConvNeXt-T's four stages (and a wide image, split into segments): at
    # most DW_CTAS_PER_SM CTAs an SM over all channel tiles, each within its
    # share of shared memory; no padding along a row at 224^2
    for itemsize in (2, 4):
        plan = dwconv.dw_plan(*shape, itemsize)
        assert plan.slots * plan.tiles <= dwconv.DW_CTAS_PER_SM * dwconv.H100_SMS
        assert plan.smem_bytes <= dwconv.DW_SMEM_PER_CTA
        assert plan.slots <= plan.items  # no CTA without an item
    bf16 = dwconv.dw_plan(*shape, 2)
    assert bf16.seg * bf16.segs == shape[2]
    assert bf16.stages >= 2  # the next item loads while one computes


@pytest.mark.parametrize("hw", [7, 13, 14, 28, 56, 224])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_dw_plan_layout_holds_the_tiles(hw, itemsize):
    # what the kernel's launch checks before it takes the layout: odd rows
    # at least as wide as the boxes' columns, 128-byte aligned tiles that
    # hold the TMA boxes, and a request that holds every stage
    plan = dwconv.dw_plan(2, hw, hw, 16, itemsize)
    px = dwconv.DW_CHANNELS * itemsize  # bytes a pixel of a tile
    assert plan.row_x % 2 == 1 and plan.row_x >= plan.seg + 2 * dwconv.PAD
    assert plan.row_dy % 2 == 1 and plan.row_dy >= plan.seg
    assert plan.x_bytes % 128 == 0 and plan.stage_bytes % 128 == 0
    assert plan.x_bytes >= (dwconv.DW_ROWS + 2 * dwconv.PAD) * plan.row_x * px
    assert plan.stage_bytes - plan.x_bytes >= dwconv.DW_ROWS * plan.row_dy * px
    assert plan.smem_bytes == plan.stages * plan.stage_bytes + 128


def _fwd_cta_work(plan, H, W, C, slot, tile):
    """What CTA (slot, tile) of the forward's `plan` stores, as
    csrc/dwconv7x7.cu indexes it: a list of (batch, rows, columns, channels)
    ranges, one per item."""
    work = []
    for i in range(slot, plan.items, plan.slots):
        b, rem = divmod(i, plan.bands * plan.segs)
        band, s = divmod(rem, plan.segs)
        work.append((b, range(band * plan.rows, min(H, (band + 1) * plan.rows)),
                     range(s * plan.seg, min(W, (s + 1) * plan.seg)),
                     range(tile * dwconv.FWD_CHANNELS, min(C, (tile + 1) * dwconv.FWD_CHANNELS))))
    return work


@pytest.mark.parametrize("hw", [7, 13, 14, 28, 56, 224])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_fwd_plan_covers_every_output_pixel_once(hw, itemsize):
    # the forward kernel's items, as it indexes them, store every (batch,
    # row, column, channel) exactly once over all CTAs (slot, tile)
    B, C = 3, 40  # two channel tiles, the last one ragged
    plan = dwconv.fwd_plan(B, hw, hw, C, itemsize)
    seen = np.zeros((B, hw, hw, C), np.int64)
    for tile in range(plan.tiles):
        for slot in range(plan.slots):
            work = _fwd_cta_work(plan, hw, hw, C, slot, tile)
            assert work, "every CTA computes at least one item"
            for b, rows, cols, chans in work:
                assert len(rows) <= plan.rows and len(cols) <= plan.seg
                seen[b, rows.start:rows.stop, cols.start:cols.stop, chans.start:chans.stop] += 1
    assert (seen == 1).all()
    assert plan.seg in dwconv.FWD_SEGMENTS and plan.rows <= dwconv.FWD_MAX_ROWS
    assert plan.threads == 32 * -(-plan.rows // 4)


@pytest.mark.parametrize("shape", [(64, 56, 56, 96), (64, 28, 28, 192), (64, 14, 14, 384),
                                   (64, 7, 7, 768)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_fwd_plan_layout_holds_the_halo_tile_and_fits_the_ctas_of_an_sm(shape, itemsize):
    # what the launch checks: odd rows at least seg + 6 pixels wide, a
    # 128-byte aligned stage that holds the (rows + 6)-row TMA box, a
    # request that holds every stage; and the CTAs the plan counts on an SM
    # fit its shared memory beside their static parts and runtime reserve
    B, H, W, C = shape
    plan = dwconv.fwd_plan(*shape, itemsize)
    assert plan.row_px % 2 == 1 and plan.row_px >= plan.seg + 2 * dwconv.PAD
    assert plan.stage_bytes % 128 == 0
    assert plan.stage_bytes >= ((plan.rows + 2 * dwconv.PAD) * plan.row_px
                                * dwconv.FWD_CHANNELS * itemsize)
    assert plan.smem_bytes == plan.stages * plan.stage_bytes + 128
    assert plan.smem_bytes <= dwconv.FWD_SMEM_MAX
    per_sm = -(-plan.slots * plan.tiles // dwconv.H100_SMS)
    assert per_sm * (plan.smem_bytes + dwconv.FWD_STATIC_BYTES + 1024) <= dwconv.SMEM_PER_SM
    assert per_sm * plan.threads <= dwconv.FWD_THREADS_PER_SM
    assert plan.slots <= plan.items
    assert plan.bands * plan.rows >= H and (plan.bands - 1) * plan.rows < H
    assert plan.stages >= 2  # the next item loads while one computes
    if itemsize == 2:
        assert plan.seg * plan.segs == W  # no padded columns at ConvNeXt-T's widths


def _c_struct_fields(name):
    """The field names of `struct name` in csrc/dwconv7x7.cu, in order."""
    src = (Path(dwconv.__file__).parent.parent / "csrc" / "dwconv7x7.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    return re.findall(r"^\s*\w+\s+(\w+);", body, re.M)


@pytest.mark.parametrize("struct,plan,c_name,c_plan", [
    (dwconv._FwdLaunch, dwconv.FwdPlan, "FwdLaunch", "FwdPlan"),
    (dwconv._DwLaunch, dwconv.DwPlan, "DwLaunch", "DwPlan"),
])
def test_launch_structures_have_the_c_structs_fields_in_order(struct, plan, c_name, c_plan):
    # ctypes lays a Structure out by its _fields_ order: it must be the C
    # struct's (the size check against the library runs on the card)
    assert [f for f, _ in struct._fields_] == _c_struct_fields(c_name)
    assert list(plan._fields) == _c_struct_fields(c_plan)
    assert struct._fields_[-1][1]._length_ == len(plan._fields)


@pytest.mark.parametrize("needs_grad", [False, True])
def test_autograd_node_only_when_an_input_requires_a_gradient(needs_grad):
    x, w = (torch.from_numpy(a) for a in _xw((1, 7, 7, 8), seed=8))
    y = dwconv.depthwise_conv7x7(x.requires_grad_(needs_grad), w)
    assert (y.grad_fn is not None) == needs_grad
    with torch.no_grad():
        assert dwconv.depthwise_conv7x7(x, w).grad_fn is None
    torch.testing.assert_close(y.detach(), dwconv.dwconv7x7_ref(x.detach(), w), rtol=0, atol=0)


CARD_SHAPES = [(2, 12, 10, 8), (3, 9, 13, 40), (4, 28, 28, 192), (2, 56, 56, 96),
               (2, 7, 7, 768), (1, 1, 1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_version_on_card(cuda_device, launches, shape, dtype):
    x, w = (torch.from_numpy(a).to(cuda_device, dtype) for a in _xw(shape, seed=sum(shape)))
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal(shape).astype(np.float32))
    dy = dy.to(cuda_device, dtype)
    y = dwconv.depthwise_conv7x7(x, w)
    dx, dw = dwconv.dwconv7x7_bwd(x, w, dy)
    torch.cuda.synchronize()
    d = dwconv.depthwise_conv7x7
    assert (d.launches, d.launches_dx, d.launches_dw) == (1, 1, 1)
    assert y.dtype == dx.dtype == dw.dtype == dtype
    # fp32: 49-term sums in another order (1e-5 of the largest value), dw
    # sums B*H*W terms (1e-4); bf16 outputs: one rounding, 2^-7 of the largest
    for name, got, want, rel in (
            ("y", y, dwconv.dwconv7x7_ref(x, w), 1e-5),
            ("dx", dx, dwconv.dwconv7x7_ref(dy, w, flip=True), 1e-5),
            ("dw", dw, dwconv.dwconv7x7_dw_ref(x, dy, torch.float32), 1e-4)):
        rel = rel if dtype == torch.float32 else 2.0 ** -7
        tol = rel * want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, f"{name}: max|d| {err} > {tol}"


@pytest.mark.cuda
def test_kernels_take_a_bf16_input_with_fp32_weights_on_card(cuda_device):
    x, w = (torch.from_numpy(a).to(cuda_device) for a in _xw((2, 14, 14, 64), seed=7))
    xb = x.bfloat16()
    y = dwconv.depthwise_conv7x7(xb, w)  # the Pallas kernel casts w inside
    want = dwconv.dwconv7x7_ref(xb, w)
    assert y.dtype == torch.bfloat16
    assert (y.float() - want.float()).abs().max() <= 2.0 ** -7 * want.float().abs().max()
    first = dwconv.dwconv7x7_bwd(xb, w, xb)
    for a, c in zip(first, dwconv.dwconv7x7_bwd(xb, w, xb)):
        assert torch.equal(a, c)  # no atomics: the same bits every run


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 40, 96, 200, 768])
@pytest.mark.parametrize("hw", [7, 13, 28, 56])
def test_dw_kernel_matches_plain_version_and_repeats_on_card(cuda_device, hw, C):
    # bf16 x and dy, fp32 dw: sums of H*W terms in fp32 in another order,
    # 1e-4 of the largest value; no atomics, so a second run gives the same bits
    x, _ = _xw((1, hw, hw, C), seed=hw + C)
    dy = np.random.default_rng(hw * C).standard_normal(x.shape).astype(np.float32)
    x, dy = (torch.from_numpy(a).to(cuda_device, torch.bfloat16) for a in (x, dy))
    first = dwconv._launch_dw(x, dy, torch.float32)
    second = dwconv._launch_dw(x, dy, torch.float32)
    torch.cuda.synchronize()
    want = dwconv.dwconv7x7_dw_ref(x, dy, torch.float32)
    err = (first - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), f"max|d| {err}"
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [8, 40, 96, 200, 768])
@pytest.mark.parametrize("hw", [7, 13, 28, 56])
def test_forward_and_dx_match_plain_version_on_card(cuda_device, launches, hw, C, dtype):
    # the forward kernel at each segment width (7, 14, 28) and band height,
    # ragged channel tiles (8, 40, 200) and full ones; fp32: 49-term sums in
    # another order, 1e-5 of the largest value; bf16: one rounding, 2^-7
    x, w = (torch.from_numpy(a).to(cuda_device, dtype) for a in _xw((2, hw, hw, C), seed=hw + C))
    dy = torch.from_numpy(np.random.default_rng(hw * C).standard_normal(x.shape)
                          .astype(np.float32)).to(cuda_device, dtype)
    y = dwconv.depthwise_conv7x7(x, w)
    dx = dwconv._launch_fwd(dy, w, flip=True)
    torch.cuda.synchronize()
    d = dwconv.depthwise_conv7x7
    assert (d.launches, d.launches_dx) == (1, 1)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for name, got, want in (("y", y, dwconv.dwconv7x7_ref(x, w)),
                            ("dx", dx, dwconv.dwconv7x7_ref(dy, w, flip=True))):
        assert got.dtype == dtype
        tol = rel * want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, f"{name}: max|d| {err} > {tol}"
