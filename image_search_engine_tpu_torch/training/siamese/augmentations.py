"""Batched image augmentations on the device.

Port of ``image_search_engine_tpu/training/siamese/augmentations.py``: the
reference's albumentations Compose, op for op, each op firing per image
with its probability in ``OP_PROBS``:

  HueSaturationValue(p=.5), RandomBrightnessContrast(p=.5),
  RandomGamma(60..120, p=.5), ISONoise(p=.5), PixelDropout(p=.5),
  Blur(limit 5, p=.5), CoarseDropout(p=.1),
  ShiftScaleRotate(zoom-out only, p=.5), Perspective(p=.3),
  ShiftScaleRotate(shift only .05, p=.5), SafeRotate(10deg, p=.1),
  OpticalDistortion(p=.5); every geometric op pads WHITE (card images).

It comes in two halves. :func:`sample_params` draws every gate, scalar,
noise field and mask from an explicit ``torch.Generator`` (on the device
the images live on); :func:`apply` is a pure function of the images and
those parameters, so a test can feed it parameters drawn otherwise (the
JAX package's, from its key). :func:`augment_batch` is both.

As in the JAX package, the geometric ops compose into ONE bilinear
resample of the output grid: the grid goes through the optical distortion,
then the perspective, then one affine matrix per image (zoom-out, shift
and rotation folded together), and the image is sampled once. Ungated ops
contribute identity parameters. The sample's four taps replicate the
image's edge, and a pixel whose unclipped source coordinate lies outside
[0, h-1] x [0, w-1] is white. The box blur pads zeros. The gather is plain
tensor indexing (the JAX package's chunked gather works around a TPU
gather cliff and has no counterpart here).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops.image_ops import rgb_to_hsv

# albumentations p= of each op in the reference Compose (order preserved)
OP_PROBS = {
    "hsv": 0.5,
    "brightness_contrast": 0.5,
    "gamma": 0.5,
    "iso_noise": 0.5,
    "pixel_dropout": 0.5,
    "blur": 0.5,
    "coarse_dropout": 0.1,
    "zoom_out": 0.5,
    "perspective": 0.3,
    "shift": 0.5,
    "safe_rotate": 0.1,
    "optical_distortion": 0.5,
}
_ROT = 10.0 * math.pi / 180.0  # SafeRotate's limit, radians

#: the per-image scalars of ``sample_params`` and their ranges; each is
#: used where its op's gate is set
RANGES = {
    "bright": (-0.2, 0.2), "contrast": (0.8, 1.2), "gamma": (0.6, 1.2),
    "hue": (-15.0, 15.0), "sat": (0.85, 1.15), "noise_sigma": (0.0, 0.03),
    "distort": (-0.05, 0.05), "persp_y": (-0.1, 0.1), "persp_x": (-0.1, 0.1),
    "scale": (0.9, 1.0), "rot": (-1.0, 1.0), "shift_y": (-0.05, 0.05),
    "shift_x": (-0.05, 0.05),
}


def sample_params(generator: torch.Generator, b: int, h: int, w: int) -> dict:
    """Every random draw of one augmentation of a (b, h, w, 3) batch, on
    the generator's device: ``gates`` ({op: (b,) bool}), the (b,) scalars
    of ``RANGES``, ``noise`` (b, h, w, 3) standard normal, ``drop`` (b, h,
    w) bool (1% of pixels), ``blur5`` (b,) bool (a 5-tap box, else 3),
    ``hole_y`` / ``hole_x`` (b,) int64 (the coarse dropout's centre)."""
    dev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    params = {"gates": {n: rand(b) < OP_PROBS[n] for n in sorted(OP_PROBS)}}
    for name, (lo, hi) in RANGES.items():
        params[name] = lo + (hi - lo) * rand(b)
    params["noise"] = torch.randn((b, h, w, 3), generator=generator, device=dev)
    params["drop"] = rand(b, h, w) < 0.01
    params["blur5"] = rand(b) < 0.5
    params["hole_y"] = torch.randint(0, h, (b,), generator=generator, device=dev)
    params["hole_x"] = torch.randint(0, w, (b,), generator=generator, device=dev)
    return params


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v with a device tensor as divisor: a correctly rounded quotient
    on CUDA too (a host scalar divisor becomes a reciprocal product)."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of ops/image_ops.rgb_to_hsv (H in degrees)."""
    h, s, v = _div(hsv[..., 0], 60.0), hsv[..., 1], hsv[..., 2]
    c = v * s
    x = c * (1.0 - torch.abs(torch.remainder(h, 2.0) - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    i = torch.clamp(torch.floor(h).to(torch.int32), 0, 5)
    sel = [i == k for k in range(6)]

    def select(vals):
        out = vals[-1]
        for cond, val in zip(reversed(sel[:-1]), reversed(vals[:-1])):
            out = torch.where(cond, val, out)
        return out

    r = select([c, x, z, z, x, c])
    g = select([x, c, c, x, z, z])
    b = select([z, z, x, c, c, x])
    return torch.stack([r + m, g + m, b + m], dim=-1)


def _box_blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable box blur over (B, H, W, C), zero-padded (the JAX
    package's ``conv_general_dilated`` with zero pads)."""
    b, h, w, c = x.shape
    pad = ksize // 2
    kern = torch.full((1, 1, ksize, 1), 1.0 / ksize, dtype=x.dtype, device=x.device)
    xp = x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    xp = F.conv2d(xp, kern, padding=(pad, 0))
    xp = F.conv2d(xp, kern.view(1, 1, 1, ksize), padding=(0, pad))
    return xp.reshape(b, c, h, w).permute(0, 2, 3, 1)


def source_grid(params: dict, b: int, h: int, w: int, device) -> tuple:
    """(src_y, src_x), each (b, h, w) f32: where each output pixel samples
    the input, through the distortion, the perspective and the affine
    matrix in turn (identities where an op's gate is off)."""
    g = params["gates"]
    f32 = torch.float32
    cyy, cxx = (h - 1) / 2.0, (w - 1) / 2.0
    gy = torch.arange(h, dtype=f32, device=device)[None, :, None].expand(b, h, w)
    gx = torch.arange(w, dtype=f32, device=device)[None, None, :].expand(b, h, w)

    def gated(name, gate, identity=0.0):
        return torch.where(g[gate], params[name], identity)

    # optical distortion: radial barrel / pincushion about the centre
    kk = gated("distort", "optical_distortion")[:, None, None]
    ny = _div(gy - cyy, max(cyy, 1.0))
    nx = _div(gx - cxx, max(cxx, 1.0))
    f = 1.0 + kk * (ny * ny + nx * nx)
    gy = cyy + ny * f * cyy
    gx = cxx + nx * f * cxx

    # perspective: small projective terms about the centre
    py = _div(gated("persp_y", "perspective"), max(h, 1))[:, None, None]
    px = _div(gated("persp_x", "perspective"), max(w, 1))[:, None, None]
    denom = 1.0 + py * (gy - cyy) + px * (gx - cxx)
    gy = (gy - cyy) / denom + cyy
    gx = (gx - cxx) / denom + cxx

    # the affine family as one output -> input matrix per image
    s = gated("scale", "zoom_out", 1.0)
    theta = torch.where(g["safe_rotate"], params["rot"] * _ROT, 0.0)
    ty = torch.where(g["shift"], params["shift_y"] * h, 0.0)
    tx = torch.where(g["shift"], params["shift_x"] * w, 0.0)
    inv = 1.0 / s
    cos_t, sin_t = torch.cos(theta) * inv, torch.sin(theta) * inv
    m02 = cyy - cos_t * cyy + sin_t * cxx + ty
    m12 = cxx - sin_t * cyy - cos_t * cxx + tx
    c, s_ = cos_t[:, None, None], sin_t[:, None, None]
    return (c * gy + (-s_) * gx + m02[:, None, None],
            s_ * gy + c * gx + m12[:, None, None])


def remap(imgs: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor,
          fill: float = 1.0) -> torch.Tensor:
    """Bilinear-sample a (B, H, W, C) batch at per-image (B, H, W) source
    coordinates: the four taps at the clipped corner and its right / lower
    neighbours (edge-replicated), ``fill`` where the unclipped coordinate
    lies outside the image."""
    b, h, w, _ = imgs.shape
    y0f, x0f = torch.floor(src_y), torch.floor(src_x)
    wy, wx = (src_y - y0f)[..., None], (src_x - x0f)[..., None]
    yc = torch.clamp(y0f.long(), 0, h - 1)
    xc = torch.clamp(x0f.long(), 0, w - 1)
    yd, xr = torch.clamp(yc + 1, max=h - 1), torch.clamp(xc + 1, max=w - 1)
    bi = torch.arange(b, device=imgs.device)[:, None, None]
    out = (imgs[bi, yc, xc] * ((1 - wy) * (1 - wx))
           + imgs[bi, yc, xr] * ((1 - wy) * wx)
           + imgs[bi, yd, xc] * (wy * (1 - wx))
           + imgs[bi, yd, xr] * (wy * wx))
    inside = ((src_y >= 0) & (src_y <= h - 1) & (src_x >= 0) & (src_x <= w - 1))[..., None]
    return torch.where(inside, out, fill)


def apply(images: torch.Tensor, params: dict) -> torch.Tensor:
    """The full augmentation stack over (B, H, W, 3) RGB [0, 1] f32 images
    with the draws ``params`` (``sample_params``'s layout)."""
    b, h, w, _ = images.shape
    g = {n: v[:, None, None, None] for n, v in params["gates"].items()}

    def per_image(name):
        return params[name][:, None, None, None]

    x = images
    # brightness / contrast (RandomBrightnessContrast)
    bc = torch.clamp((x - 0.5) * per_image("contrast") + 0.5 + per_image("bright"), 0.0, 1.0)
    x = torch.where(g["brightness_contrast"], bc, x)
    # gamma (RandomGamma, exponent 0.6..1.2)
    x = torch.where(g["gamma"], torch.clamp(x, 1e-6, 1.0) ** per_image("gamma"), x)
    # HSV jitter (HueSaturationValue)
    hsv = rgb_to_hsv(x)
    hue = torch.remainder(hsv[..., 0] + params["hue"][:, None, None], 360.0)
    sat = torch.clamp(hsv[..., 1] * params["sat"][:, None, None], 0.0, 1.0)
    jittered = _hsv_to_rgb(torch.stack([hue, sat, hsv[..., 2]], dim=-1))
    x = torch.where(g["hsv"], torch.clamp(jittered, 0.0, 1.0), x)
    # ISO-style gaussian noise
    noised = torch.clamp(x + per_image("noise_sigma") * params["noise"], 0.0, 1.0)
    x = torch.where(g["iso_noise"], noised, x)
    # pixel dropout: ~1% of pixels to 0
    x = torch.where(g["pixel_dropout"] & params["drop"][..., None], 0.0, x)
    # blur: a box of 3 or 5 taps
    blurred = torch.where(params["blur5"][:, None, None, None], _box_blur(x, 5), _box_blur(x, 3))
    x = torch.where(g["blur"], blurred, x)
    # coarse dropout: one white square per image
    sz = h // 8
    gy = torch.arange(h, device=x.device)[None, :, None]
    gx = torch.arange(w, device=x.device)[None, None, :]
    hole = ((torch.abs(gy - params["hole_y"][:, None, None]) < sz)
            & (torch.abs(gx - params["hole_x"][:, None, None]) < sz))
    x = torch.where(g["coarse_dropout"] & hole[..., None], 1.0, x)
    # the geometric family: one resample
    src_y, src_x = source_grid(params, b, h, w, x.device)
    any_geo = (g["zoom_out"] | g["shift"] | g["safe_rotate"] | g["perspective"]
               | g["optical_distortion"])
    x = torch.where(any_geo, remap(x, src_y, src_x), x)
    return torch.clamp(x, 0.0, 1.0)


def augment_batch(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """``apply`` with fresh draws from ``generator`` (on the images' device)."""
    b, h, w, _ = images.shape
    return apply(images, sample_params(generator, b, h, w))
