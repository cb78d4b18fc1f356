"""Port fused 1x1 conv + BN statistics (imageclassification_tpu_torch/ops/
conv1x1_bn.py) against the JAX package's `conv1x1_bn_stats`, whose Pallas
kernel runs in interpret mode on the CPU (as tests/test_pallas_conv1x1_bn.py
runs it), and its `xla_reference`. On the CPU the port's wrapper takes its
plain version; the CUDA kernel is checked by the `cuda` tests on a card (and
by chip_smoke.py). JAX is imported inside the tests that use it, so the
`cuda` tests of this file also run where JAX is absent:

    python -m pytest --noconftest tests/test_torch_conv1x1_bn.py -m cuda
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from imageclassification_tpu_torch.ops import conv1x1_bn as k2


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the suite runs several pytest workers at once; torch's default of one
    # thread per core in each of them oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_k2(monkeypatch):
    """The JAX pallas_conv1x1_bn module, its kernel in interpret mode."""
    import jax.experimental.pallas as pl

    from imageclassification_tpu.ops import pallas_conv1x1_bn as pk

    orig = pl.pallas_call
    monkeypatch.setattr(pk.pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    return pk


@pytest.fixture
def launches(monkeypatch):
    for name in ("launches", "launches_bn_in"):
        monkeypatch.setattr(k2.conv1x1_bn_stats, name, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the conv1x1_bn kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(m, k, n, seed, bn_in):
    """x [m, k] (post-ReLU without the prologue, a conv output with it), w
    [k, n] of std sqrt(2 / k), and with the prologue a scale and shift [k]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x = x if bn_in else np.maximum(x, 0.0)
    w = (rng.standard_normal((k, n)) * (2.0 / k) ** 0.5).astype(np.float32)
    if not bn_in:
        return x, w, None, None
    return (x, w, rng.uniform(0.5, 1.5, k).astype(np.float32),
            (0.3 * rng.standard_normal(k)).astype(np.float32))


def _torch(a, dtype=torch.float32, device="cpu"):
    return None if a is None else torch.from_numpy(a).to(device, dtype)


def _assert_stats(got, want, y_abs_sum, rtol, what):
    """Each column's sum within rtol of its sum of |y|, its sum of squares
    within rtol of itself."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got[0] - want[0]) <= rtol * y_abs_sum), f"{what}: column sums"
    assert np.all(np.abs(got[1] - want[1]) <= rtol * want[1]), f"{what}: sums of squares"


VARIANTS = {"plain": (False, True), "bn_in_relu": (True, True), "bn_in_no_relu": (True, False)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_version_matches_pallas_kernel(pallas_k2, variant, dtype):
    # M a multiple of 128, as the Pallas kernel requires. fp32: the product
    # summed in another order, y to 1e-5; bf16: both sides accumulate the
    # same bf16 products in fp32 and round y once, so y agrees to one bf16
    # step (2^-7 of max|y|). The statistics come from the fp32 product on
    # both sides: 1e-4 of each column's sum of |y| (sum) or of itself (sum of
    # squares), fp32 sums over 256 rows in another order
    import jax.numpy as jnp

    bn_in, relu = VARIANTS[variant]
    tdt = getattr(torch, dtype)
    x, w, scale, shift = _inputs(256, 64, 128, seed=len(variant) + len(dtype), bn_in=bn_in)
    tx, tw = _torch(x, tdt), _torch(w, tdt)
    y, stats = k2.conv1x1_bn_stats(tx, tw, _torch(scale), _torch(shift), relu_in=relu)
    assert y.dtype == tdt and stats.dtype == torch.float32 and stats.shape == (2, 128)
    jx = jnp.asarray(tx.float().numpy(), dtype)
    jw = jnp.asarray(tw.float().numpy(), dtype)
    pro = (jnp.asarray(scale), jnp.asarray(shift)) if bn_in else (None, None)
    jy, jstats = pallas_k2.conv1x1_bn_stats(jx, jw, *pro, relu_in=relu, interpret=True)
    ry, rstats = pallas_k2.xla_reference(jx, jw, *pro, relu_in=relu)
    y_abs = np.abs(np.asarray(ry, np.float32)).sum(0)
    for name, wy, ws in (("pallas", jy, jstats), ("xla_reference", ry, rstats)):
        want = np.asarray(wy, np.float32)
        peak = np.abs(want).max()
        tol = 1e-5 * (1 + peak) if dtype == "float32" else 2.0 ** -7 * peak
        np.testing.assert_allclose(y.float().numpy(), want, atol=tol, rtol=0, err_msg=name)
        _assert_stats(stats.numpy(), np.asarray(ws), y_abs, 1e-4, name)
    assert np.abs(np.asarray(jstats)[0]).max() > 1.0  # the statistics are not degenerate


def test_statistics_are_the_batchnorm_statistics_of_the_product():
    # stats [2, N] are what train-mode BN needs: mean = s0 / M and biased
    # var = s1 / M - mean^2 of the fp32 product (not of the rounded y)
    x, w, scale, shift = _inputs(300, 32, 24, seed=1, bn_in=True)
    tx, tw = _torch(x, torch.bfloat16), _torch(w, torch.bfloat16)
    y, stats = k2.conv1x1_bn_stats(tx, tw, _torch(scale), _torch(shift))
    xin = torch.relu(tx.float() * _torch(scale) + _torch(shift)).bfloat16().float()
    full = xin.double() @ tw.double()
    mean = stats[0].double() / 300
    np.testing.assert_allclose(mean.numpy(), full.mean(0).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((stats[1].double() / 300 - mean ** 2).numpy(),
                               full.var(0, unbiased=False).numpy(), rtol=1e-4, atol=1e-6)
    assert (y.float() - full.float()).abs().max() > 0  # y is rounded, the statistics are not


def test_ragged_m_matches_pallas_kernel_on_padded_rows(pallas_k2):
    # the Pallas kernel takes M in multiples of 128 only; the port takes any
    # M. Zero rows add nothing to the plain variant's y or statistics, so
    # the Pallas kernel on x padded to 256 rows gives the answer for M = 200
    import jax.numpy as jnp

    x, w, _, _ = _inputs(200, 64, 64, seed=2, bn_in=False)
    y, stats = k2.conv1x1_bn_stats(_torch(x), _torch(w))
    xp = np.concatenate([x, np.zeros((56, 64), np.float32)])
    jy, jstats = pallas_k2.conv1x1_bn_stats(jnp.asarray(xp), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:200], atol=1e-5, rtol=1e-5)
    _assert_stats(stats.numpy(), np.asarray(jstats), np.abs(np.asarray(jy)).sum(0), 1e-4, "ragged")
    with pytest.raises(ValueError, match="multiple of 128"):
        pallas_k2.conv1x1_bn_stats(jnp.asarray(x), jnp.asarray(w), interpret=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_takes_plain_version_and_launches_nothing(launches, dtype):
    x, w, scale, shift = (_torch(a, dtype if a is not None and a.ndim == 2 else torch.float32)
                          for a in _inputs(130, 16, 8, seed=3, bn_in=True))
    for pro in ((None, None), (scale, shift)):
        got = k2.conv1x1_bn_stats(x, w, *pro)
        want = k2.conv1x1_bn_ref(x, w, *pro)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert (k2.conv1x1_bn_stats.launches, k2.conv1x1_bn_stats.launches_bn_in) == (0, 0)


@pytest.mark.parametrize("case", ["k_mismatch", "half_prologue", "scale_shape", "requires_grad",
                                  "no_rows", "not_2d"])
def test_wrapper_raises_value_error(case):
    x, w = torch.zeros((16, 8)), torch.zeros((8, 16))
    s = torch.ones(8)
    args = {"k_mismatch": (x, torch.zeros((16, 16))), "half_prologue": (x, w, s, None),
            "scale_shape": (x, w, torch.ones(16), torch.ones(16)),
            "requires_grad": (x.requires_grad_(), w), "no_rows": (torch.zeros((0, 8)), w),
            "not_2d": (torch.zeros((2, 8, 8)), w)}[case]
    with pytest.raises(ValueError):
        k2.conv1x1_bn_stats(*args)


@pytest.mark.parametrize("dtype,K,N,err", [
    (torch.float32, 64, 64, NotImplementedError),   # the kernel takes bf16 only
    (torch.float16, 64, 64, NotImplementedError),
    (torch.bfloat16, 36, 64, NotImplementedError),  # K not a multiple of 8
    (torch.bfloat16, 64, 20, NotImplementedError),  # N not a multiple of 8
    (torch.bfloat16, 2048, 512, None),              # ResNet-50's last-stage conv1
    (torch.bfloat16, 8, 8, None),
])
def test_kernel_input_checks(dtype, K, N, err):
    x, w = torch.zeros((4, K), dtype=dtype), torch.zeros((K, N), dtype=dtype)
    if err is None:
        k2.check_kernel_inputs(x, w)
    else:
        with pytest.raises(err):
            k2.check_kernel_inputs(x, w)


# ResNet-50's nine 1x1 shapes at batch 64 (chip_smoke.py K2_SHAPES) and the
# widest K of the port's ResNets
RESNET50_SHAPES = [(200704, 64, 256, True), (200704, 256, 64, False), (50176, 128, 512, True),
                   (50176, 512, 128, False), (12544, 256, 1024, True), (12544, 1024, 256, False),
                   (3136, 512, 2048, True), (3136, 2048, 512, False), (3136, 1024, 2048, False)]


@pytest.mark.parametrize("M", [1, 127, 3136, 200704])
@pytest.mark.parametrize("K,N", [(64, 256), (2048, 512), (24, 136)])
def test_k2_plan_covers_every_tile_once(M, K, N):
    # CTA (slot, n) walks the M-tiles slot, slot + slots, ... of N-tile n,
    # which covers each M-tile once, and gives each CTA one at least, when
    # 1 <= slots <= m_tiles; the grid is slots x n_tiles, one CTA an SM, in
    # as few rounds of M-tiles as that allows
    plan = k2.k2_plan(M, K, N, bn_in=True)
    assert plan.m_tiles * k2.TILE_M >= M > (plan.m_tiles - 1) * k2.TILE_M
    assert plan.n_tiles * k2.TILE_N >= N > (plan.n_tiles - 1) * k2.TILE_N
    assert 1 <= plan.slots <= plan.m_tiles
    assert plan.slots * plan.n_tiles <= max(k2.H100_SMS, plan.n_tiles)
    rounds = -(-plan.m_tiles // plan.slots)
    assert rounds == -(-plan.m_tiles // max(1, min(plan.m_tiles, k2.H100_SMS // plan.n_tiles)))


@pytest.mark.parametrize("M,K,N", [(1, 8, 8), (3136, 512, 2048), (200704, 64, 256)])
def test_k2_partial_rows_number_the_ctas(M, K, N):
    # the partials are [slots, 2N], a row for each slot of CTAs: CTA (slot, n)
    # writes row slot at its N-tile's columns of both halves (sums, sums of
    # squares), so the grid's slots x n_tiles CTAs write each entry exactly
    # once
    plan = k2.k2_plan(M, K, N, bn_in=False)
    written = np.zeros((plan.slots, 2 * N), np.int64)
    for n in range(plan.n_tiles):
        cols = np.arange(n * k2.TILE_N, min(N, (n + 1) * k2.TILE_N))
        for slot in range(plan.slots):
            written[slot, cols] += 1
            written[slot, N + cols] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("shape", RESNET50_SHAPES + [(3136, 1024, 2048, True), (64, 2048, 8, True),
                                                     (1000, 72, 200, False)])
def test_k2_plan_fits_shared_memory(shape):
    # the layout the launch checks: W's slice resident exactly when it fits
    # beside two stages, at least two stages, and the whole layout (+1024 of
    # alignment) within the 227 KB a CTA may ask for, at K up to 2048
    M, K, N, bn_in = shape
    plan = k2.k2_plan(M, K, N, bn_in)
    fixed = k2.Y_BYTES + plan.ss_bytes + k2.RED_BYTES + 1024
    assert plan.ss_bytes == (2 * plan.k_chunks * k2.CHUNK_K * 4 if bn_in else 0)
    assert plan.resident == int(plan.k_chunks * k2.CHUNK_BYTES + 2 * k2.CHUNK_BYTES + fixed
                                <= k2.SMEM_MAX)
    assert plan.stage_bytes == k2.CHUNK_BYTES * (1 if plan.resident else 2)
    assert plan.w_bytes == (plan.k_chunks * k2.CHUNK_BYTES if plan.resident else 0)
    assert 2 <= plan.stages <= k2.MAX_STAGES
    assert plan.smem_bytes == plan.w_bytes + plan.stages * plan.stage_bytes + fixed
    assert plan.smem_bytes <= k2.SMEM_MAX
    assert plan.resident == int(K <= 512)  # at ResNet widths: W streamed from K = 1024


def test_launch_structure_has_the_c_structs_fields_in_order():
    # ctypes lays a Structure out by its _fields_ order: it must be the C
    # struct's (the size check against the library runs on the card)
    src = (Path(k2.__file__).parent.parent / "csrc" / "conv1x1_bn.cu").read_text()

    def fields(name):
        body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
        return re.findall(r"^\s*(?:long long|\w+)\s+(\w+);", body, re.M)

    assert [f for f, _ in k2._Launch._fields_] == fields("Launch")
    assert list(k2.K2Plan._fields) == fields("Plan")
    assert k2._Launch._fields_[-1][1]._length_ == len(k2.K2Plan._fields)


# (M, K, N, prologue): ragged M (3136 = ResNet-50's last stage at batch 64,
# and tiles of 1 and 129 rows), K not a multiple of the 32-deep slice, N not
# a multiple of the 128-wide tile, and two full-size ResNet-50 shapes
CARD_SHAPES = [(3136, 512, 2048, True), (3136, 2048, 512, False), (1, 8, 8, False),
               (129, 40, 24, True), (1000, 72, 200, False), (50176, 128, 512, True),
               (12544, 1024, 256, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_plain_version_on_card(cuda_device, launches, shape, relu):
    M, K, N, bn_in = shape
    x, w, scale, shift = _inputs(M, K, N, seed=M + K + N, bn_in=bn_in)
    tx, tw = _torch(x, torch.bfloat16, cuda_device), _torch(w, torch.bfloat16, cuda_device)
    ts, th = _torch(scale, device=cuda_device), _torch(shift, device=cuda_device)
    y, stats = k2.conv1x1_bn_stats(tx, tw, ts, th, relu_in=relu)
    torch.cuda.synchronize()
    assert (k2.conv1x1_bn_stats.launches, k2.conv1x1_bn_stats.launches_bn_in) == \
        ((0, 1) if bn_in else (1, 0))
    ref_y, ref_stats = k2.conv1x1_bn_ref(tx, tw, ts, th, relu_in=relu)
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    # y: one bf16 rounding of an fp32 sum taken in another order, 2^-7 of
    # max|ref|; statistics: fp32 sums over M rows in another order, 1e-4
    tol = 2.0 ** -7 * ref_y.float().abs().max().item()
    assert (y.float() - ref_y.float()).abs().max().item() <= tol
    xin = tx.float()
    if bn_in:
        xin = xin * ts + th
        xin = (torch.relu(xin) if relu else xin).bfloat16().float()
    full = xin @ tw.float()
    _assert_stats(stats.cpu().numpy(), ref_stats.cpu().numpy(),
                  full.abs().sum(0).cpu().numpy(), 1e-4, f"{shape}")
    again = k2.conv1x1_bn_stats(tx, tw, ts, th, relu_in=relu)
    assert torch.equal(again[0], y) and torch.equal(again[1], stats)  # no atomics: same bits


@pytest.mark.cuda
def test_kernel_takes_strided_inputs_on_card(cuda_device):
    # the downsample's input x[:, ::2, ::2] of an NHWC tensor, and the conv
    # weight [N, K] read transposed: not contiguous, the wrapper copies them
    x = torch.relu(torch.randn((2, 14, 14, 64), device=cuda_device)).bfloat16()
    w = (0.1 * torch.randn((128, 64), device=cuda_device)).bfloat16().t()
    xs = x[:, ::2, ::2].reshape(-1, 64)
    y, stats = k2.conv1x1_bn_stats(xs, w)
    ref_y, ref_stats = k2.conv1x1_bn_ref(xs.contiguous(), w)
    assert (y.float() - ref_y.float()).abs().max() <= 2.0 ** -7 * ref_y.float().abs().max()
    torch.testing.assert_close(stats, ref_stats, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bn_in,relu", [(False, True), (True, True), (True, False)])
@pytest.mark.parametrize("M", [1, 65, 3136])
def test_kernel_takes_ragged_m_and_narrow_widths_on_card(cuda_device, launches, M, bn_in, relu):
    # K = 24 and N = 136: multiples of 8 but not of the 64-deep chunk or the
    # 128-wide tile; with the prologue the zero rows past M become
    # relu(shift) != 0 in the kernel, and must stay out of the statistics
    K, N = 24, 136
    x, w, scale, shift = _inputs(M, K, N, seed=M + 7, bn_in=bn_in)
    if bn_in:
        shift = np.abs(shift) + 0.5  # relu(shift) > 0: a row past M would count
    tx, tw = _torch(x, torch.bfloat16, cuda_device), _torch(w, torch.bfloat16, cuda_device)
    ts, th = _torch(scale, device=cuda_device), _torch(shift, device=cuda_device)
    y, stats = k2.conv1x1_bn_stats(tx, tw, ts, th, relu_in=relu)
    torch.cuda.synchronize()
    ref_y, ref_stats = k2.conv1x1_bn_ref(tx, tw, ts, th, relu_in=relu)
    assert y.shape == (M, N)
    tol = 2.0 ** -7 * ref_y.float().abs().max().item()
    assert (y.float() - ref_y.float()).abs().max().item() <= tol
    xin = tx.float()
    if bn_in:
        xin = xin * ts + th
        xin = (torch.relu(xin) if relu else xin).bfloat16().float()
    _assert_stats(stats.cpu().numpy(), ref_stats.cpu().numpy(),
                  (xin @ tw.float()).abs().sum(0).cpu().numpy(), 1e-4, f"M={M}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200704, 64, 256, True), (12544, 1024, 256, False),
                                   (3136, 512, 2048, True)])
def test_kernel_is_bitwise_repeatable_on_card(cuda_device, shape):
    # no atomics, a fixed schedule and fixed summation orders: two runs give
    # the same bits in y and in the statistics (W resident and streamed)
    M, K, N, bn_in = shape
    x, w, scale, shift = _inputs(M, K, N, seed=11, bn_in=bn_in)
    args = (_torch(x, torch.bfloat16, cuda_device), _torch(w, torch.bfloat16, cuda_device),
            _torch(scale, device=cuda_device), _torch(shift, device=cuda_device))
    first, second = k2.conv1x1_bn_stats(*args), k2.conv1x1_bn_stats(*args)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
