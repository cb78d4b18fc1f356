"""Image primitives on a batch (port of the JAX package's `ops/image.py`),
the building blocks of the `--aa` policies (`data/randaugment.py`,
`data/abel.py`).

Every op takes and returns float32 NHWC images in [0, 255], [B, H, W, C],
and its parameters per sample as [B] tensors (a number broadcasts). They are
shape-static and branch-free, with no host read, so a policy runs inside a
captured train step. The arithmetic is the JAX functions' (PIL's integer LUT
conventions), in the same order where a rounding follows it:
* the affine resample samples at PIL's pixel centres, bilinear, each of the
  four corners outside the image taking the fill value;
* contrast rounds the grey image, then its mean;
* sharpness smooths with PIL's 3x3 SMOOTH kernel as nine shifted products
  (no convolution algorithm, so no TF32 and one order on every device),
  rounds, and keeps the 1-pixel border;
* posterize truncates to an integer and keeps the top bits with a mask, so 0
  bits give 0 on every device (a shift by 8 is not defined in C);
* equalize counts each channel's histogram with an integer `scatter_add_`
  into a [B * C, 256] tensor and builds PIL's LUT in integers (the JAX
  function's fp32 sums and floors are exact at these sizes).
"""

from __future__ import annotations

import torch

# ITU-R 601-2 luma (PIL convert('L'))
_LUMA = (0.299, 0.587, 0.114)


def _per_sample(v):
    """A [B] tensor as fp32 [B, 1, 1, 1]; a number as it is (no copy to the
    device, which a captured step may not make)."""
    return v.float().reshape(-1, 1, 1, 1) if isinstance(v, torch.Tensor) else float(v)


def _fill(fill, x: torch.Tensor) -> torch.Tensor:
    """A fill value ([C] or [B, C]) as [B or 1, 1, 1, C] on x's device (a
    policy passes a tensor already there)."""
    f = torch.as_tensor(fill, dtype=torch.float32, device=x.device)
    return f.reshape(-1, 1, 1, x.shape[-1])


# ------------------------------------------------------------------ geometric


def affine_inverse(img: torch.Tensor, coeffs: torch.Tensor, fill) -> torch.Tensor:
    """Output pixel (x, y) of sample b samples its input at (a x + b y + c,
    d x + e y + f), coeffs[b] = (a, b, c, d, e, f) [B, 6]; bilinear, each
    corner outside the image taking `fill` ([C] or [B, C])."""
    B, H, W, C = img.shape
    dev = img.device
    a, b, c, d, e, f = (coeffs[:, i].reshape(B, 1, 1).float() for i in range(6))
    # PIL samples at the output pixel centres: in = M (x + 0.5, y + 0.5) - 0.5
    ys = torch.arange(H, dtype=torch.float32, device=dev).reshape(1, H, 1) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev).reshape(1, 1, W) + 0.5
    xin = a * xs + b * ys + c - 0.5
    yin = d * xs + e * ys + f - 0.5
    x0 = torch.floor(xin)
    y0 = torch.floor(yin)
    wx = (xin - x0)[..., None]
    wy = (yin - y0)[..., None]
    flat = img.reshape(B * H * W, C)
    base = (torch.arange(B, device=dev) * (H * W)).reshape(B, 1, 1)
    fill = _fill(fill, img)

    def corner(yc, xc):
        inb = (xc >= 0) & (xc < W) & (yc >= 0) & (yc < H)
        xi = xc.clamp(0, W - 1).to(torch.int64)
        yi = yc.clamp(0, H - 1).to(torch.int64)
        vals = flat.index_select(0, (base + yi * W + xi).reshape(-1)).reshape(B, H, W, C)
        return torch.where(inb[..., None], vals, fill)

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def _coeffs(img: torch.Tensor, **entries) -> torch.Tensor:
    """[B, 6] affine coefficients: the identity with `entries` (index name ->
    [B] or number) set."""
    out = torch.zeros(img.shape[0], 6, device=img.device)
    out[:, 0] = 1.0
    out[:, 4] = 1.0
    for i, name in enumerate("abcdef"):
        if name in entries:
            v = entries[name]
            out[:, i] = v.float() if isinstance(v, torch.Tensor) else float(v)
    return out


def shear_x(img, v, fill):
    return affine_inverse(img, _coeffs(img, b=v), fill)


def shear_y(img, v, fill):
    return affine_inverse(img, _coeffs(img, d=v), fill)


def translate_x(img, pixels, fill):
    return affine_inverse(img, _coeffs(img, c=pixels), fill)


def translate_y(img, pixels, fill):
    return affine_inverse(img, _coeffs(img, f=pixels), fill)


def rotate_coeffs(degrees: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, 6] coefficients of a rotation by `degrees` [B] about the image
    centre (PIL Image.rotate): output -> input rotates by +theta."""
    theta = torch.deg2rad(degrees.float())
    # cos and sin rounded from float64, so that every device gets the same
    # fp32 values (fp32 libm's may differ in the last bit, which the pixel
    # coordinates multiply)
    cos, sin = torch.cos(theta.double()).float(), torch.sin(theta.double()).float()
    cx, cy = W / 2.0, H / 2.0
    return torch.stack([cos, sin, cx - cos * cx - sin * cy,
                        -sin, cos, cy + sin * cx - cos * cy], dim=1)


def rotate(img, degrees, fill):
    B, H, W, _ = img.shape
    if not isinstance(degrees, torch.Tensor):
        degrees = torch.full((B,), float(degrees), device=img.device)
    return affine_inverse(img, rotate_coeffs(degrees.expand(B), H, W), fill)


# ---------------------------------------------------------------- photometric


def blend(degenerate, img, factor):
    """PIL ImageEnhance: degenerate + factor * (img - degenerate), clipped."""
    return torch.clamp(degenerate + _per_sample(factor) * (img - degenerate), 0.0, 255.0)


def gray(img: torch.Tensor) -> torch.Tensor:
    """The luma [B, H, W] of NHWC images."""
    return img[..., 0] * _LUMA[0] + img[..., 1] * _LUMA[1] + img[..., 2] * _LUMA[2]


def grayscale(img):
    return gray(img)[..., None].expand(img.shape)


def adjust_brightness(img, factor):
    return blend(torch.zeros_like(img), img, factor)


def adjust_saturation(img, factor):  # PIL 'Color'
    return blend(grayscale(img), img, factor)


def adjust_contrast(img, factor):
    # PIL: the degenerate image is grey at round(mean(round(L))); the sum
    # divided by a tensor, as JAX divides (torch's mean, and a CUDA tensor
    # divided by a number, multiply by the reciprocal, which can move a mean
    # of integers off an exact .5)
    total = torch.round(gray(img)).sum(dim=(1, 2))
    mean = torch.round(total / torch.full_like(total, img.shape[1] * img.shape[2]))
    return blend(mean.reshape(-1, 1, 1, 1), img, factor)


# PIL SMOOTH: [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13
_SMOOTH = [[1.0 / 13.0, 1.0 / 13.0, 1.0 / 13.0],
           [1.0 / 13.0, 5.0 / 13.0, 1.0 / 13.0],
           [1.0 / 13.0, 1.0 / 13.0, 1.0 / 13.0]]


def adjust_sharpness(img, factor):
    """PIL SMOOTH filter with the 1-pixel border kept, rounded, then the
    enhance blend."""
    B, H, W, C = img.shape
    p = torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1))  # zero border, as SAME
    smooth = None
    for dy in range(3):
        for dx in range(3):
            term = p[:, dy:dy + H, dx:dx + W] * _SMOOTH[dy][dx]
            smooth = term if smooth is None else smooth + term
    ys = torch.arange(H, device=img.device).reshape(H, 1)
    xs = torch.arange(W, device=img.device).reshape(1, W)
    interior = ((ys > 0) & (ys < H - 1) & (xs > 0) & (xs < W - 1))[..., None]
    return blend(torch.where(interior, torch.round(smooth), img), img, factor)


def invert(img):
    return 255.0 - img


def posterize(img, bits):
    """Keep the top `bits` (0-8, [B] or a number) of each truncated value
    (PIL ImageOps.posterize); 0 bits give 0."""
    q = img.to(torch.int32)
    if isinstance(bits, torch.Tensor):
        shift = 8 - bits.to(torch.int32).reshape(-1, 1, 1, 1)
        mask = 256 - torch.bitwise_left_shift(torch.ones_like(shift), shift)
    else:
        mask = 256 - (1 << (8 - int(bits)))
    return torch.bitwise_and(q, mask).to(torch.float32)


def solarize(img, threshold):
    return torch.where(img >= _per_sample(threshold), 255.0 - img, img)


def solarize_add(img, add, threshold=128.0):
    return torch.where(img < _per_sample(threshold),
                       torch.clamp(img + _per_sample(add), 0.0, 255.0), img)


def equalize(img):
    """PIL ImageOps.equalize: per sample and channel, the LUT
    (cumulative count + step // 2) // step with step = (pixels - count of
    the last non-zero bin) // 255; the channel as it was where step is 0."""
    B, H, W, C = img.shape
    dev = img.device
    q = img.to(torch.int64)  # truncation, as JAX's astype(int32)
    # bin of each pixel in a [B * C, 256] histogram
    rows = (torch.arange(B, device=dev).reshape(B, 1, 1, 1) * C
            + torch.arange(C, device=dev).reshape(1, 1, 1, C))
    idx = rows * 256 + q
    hist = torch.zeros(B * C * 256, dtype=torch.int32, device=dev)
    hist.scatter_add_(0, idx.reshape(-1), torch.ones((), dtype=torch.int32,
                                                     device=dev).expand(idx.numel()))
    hist = hist.reshape(B * C, 256)
    bins = torch.arange(256, device=dev)
    last = torch.where(hist > 0, bins, -1).amax(dim=1, keepdim=True)
    last_count = hist.gather(1, last.clamp(min=0))
    step = (H * W - last_count) // 255
    csum = torch.cumsum(hist, dim=1) - hist  # counts of the bins below
    lut = ((csum + step // 2) // step.clamp(min=1)).clamp(0, 255)
    out = torch.take(lut, idx).to(torch.float32)
    keep = (step == 0).reshape(B, 1, 1, C)
    return torch.where(keep, img, out)


def autocontrast(img):
    """PIL ImageOps.autocontrast (cutoff 0): each channel's [min, max]
    stretched to [0, 255]; a constant channel as it was."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    span = torch.clamp(hi - lo, min=1e-8)
    # a division, as JAX's: torch's `255.0 / t` multiplies by 1 / t
    scale = torch.full_like(span, 255.0) / span
    out = torch.clamp(torch.round((img - lo) * scale), 0.0, 255.0)
    return torch.where(hi <= lo, img, out)


def cutout(img, pad_size, center_y, center_x, fill):
    """Fill a (2 pad)^2 square around (center_y, center_x) ([B] or numbers),
    clipped to the image (timm / DeVries cutout)."""
    B, H, W, _ = img.shape
    dev = img.device

    def col(v):
        return v.reshape(-1, 1, 1) if isinstance(v, torch.Tensor) else v

    ys = torch.arange(H, device=dev).reshape(1, H, 1)
    xs = torch.arange(W, device=dev).reshape(1, 1, W)
    cy, cx, pad = col(center_y), col(center_x), col(pad_size)
    mask = (ys >= cy - pad) & (ys < cy + pad) & (xs >= cx - pad) & (xs < cx + pad)
    return torch.where(mask[..., None], _fill(fill, img), img)
