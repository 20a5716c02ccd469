"""Image preprocessing: eval (host torchvision-exact numpy, or batched on
the device) and train augmentation (batched on the device, or on the host).

Copies of bioscan_clip_tpu/data/transforms.py: the host eval half
(`tv_resize_size` :34-41, `_pil_triangle_weights`, `host_antialias_resize`
and `host_eval_image` :467-533), the device eval half (`resize_shorter_side`
:43-53, `center_crop` :56-73, `eval_transform` :279-308,
`eval_transform_auto` :354-363), and of `_decode_jpeg` and
`_host_resize_shorter` (bioscan_clip_tpu/data/pipeline.py:32-61). The eval
pipeline (reference dataset.py:194-200: ToTensor -> Resize(256,
antialias=True) -> CenterCrop(224)) runs bit-faithfully on the host in
float32: torchvision's antialias resize is PIL's separable triangle filter
on floats, and so is `host_eval_image`.

The device transform follows `jax.image.resize(..., "bilinear",
antialias=True)`, the JAX package's device resize: its triangle-kernel
weight matrices (`jax/_src/image/scale.py`, `compute_weight_mat`) are built
in numpy float32 and applied as two products on the device. It does not
follow `F.interpolate(antialias=True)`, whose edge handling differs.

The train augmentation (JAX transforms.py:76-465) runs on the device
(`train_transform`: RandomResizedCrop as two batched products, flips,
nearest rotation, CLIP Normalize for OpenCLIP, ColorJitter for INSECT), its
per-row parameters drawn apart from it (`draw_train_aug`), or on the host
behind the loader's `train_crop` (`host_train_augment`, cv2), after which
the device only casts, normalizes and jitters.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@functools.lru_cache(maxsize=None)
def _device_constant(values, device: torch.device):
    """A fixed fp32 tensor (nested tuples of floats) on `device`, copied
    there once: a step that reuses it makes no host-to-device copy, so it
    can be captured into a CUDA graph."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _normalize_clip(x):
    mean = _device_constant(CLIP_MEAN, x.device)
    std = _device_constant(CLIP_STD, x.device)
    return (x - mean) / std


def tv_resize_size(h: int, w: int, size: int):
    """torchvision Resize(int) output size: shorter side == size, longer
    side TRUNCATED (`int(size * long / short)`,
    torchvision _compute_resized_output_size)."""
    if h <= w:
        return size, max(1, int(size * w / h))
    return max(1, int(size * h / w)), size


def _pil_triangle_weights(in_size: int, out_size: int):
    """PIL precompute_coeffs (bilinear filter, support=1.0): per output
    pixel, tap indices and normalized triangle weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # bilinear support (1.0) * filterscale
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(
        np.trunc(centers + support + 0.5).astype(np.int64), in_size
    )
    K = int((xmax - xmin).max())
    idx = xmin[:, None] + np.arange(K)[None, :]
    valid = idx < xmax[:, None]
    w = 1.0 - np.abs((idx - centers[:, None] + 0.5) / filterscale)
    w = np.where(valid, np.maximum(w, 0.0), 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    return np.minimum(idx, in_size - 1), w.astype(np.float32)


def host_antialias_resize(img: np.ndarray, out_h: int, out_w: int):
    """(H, W, C) float32 -> (out_h, out_w, C) float32, PIL/torchvision
    antialiased bilinear (exact coefficients, float arithmetic)."""
    img = np.asarray(img, dtype=np.float32)
    H, W, _ = img.shape
    if H != out_h:
        iy, wy = _pil_triangle_weights(H, out_h)
        img = np.einsum("ok,okwc->owc", wy, img[iy], optimize=True)
    if W != out_w:
        ix, wx = _pil_triangle_weights(W, out_w)
        img = np.einsum("ok,hokc->hoc", wx, img[:, ix], optimize=True)
    return img


def host_eval_image(img_u8: np.ndarray, size: int = 224,
                    resize_to: int = 256, normalize: bool = False):
    """Full torchvision eval pipeline on host: ToTensor -> Resize(256,
    antialias=True) -> CenterCrop(224) [-> CLIP Normalize], float32 HWC."""
    h, w = img_u8.shape[:2]
    nh, nw = tv_resize_size(h, w, resize_to)
    x = host_antialias_resize(
        np.asarray(img_u8, np.float32) / np.float32(255.0), nh, nw
    )
    top = (nh - size) // 2 if nh >= size else 0
    left = (nw - size) // 2 if nw >= size else 0
    if nh < size or nw < size:  # torchvision pads; BIOSCAN never hits this
        ph, pw = max(size - nh, 0), max(size - nw, 0)
        x = np.pad(
            x,
            ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0)),
        )
        nh, nw = x.shape[:2]
        top, left = (nh - size) // 2, (nw - size) // 2
    x = x[top:top + size, left:left + size]
    if normalize:
        x = (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(
            CLIP_STD, np.float32
        )
    return np.ascontiguousarray(x, dtype=np.float32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of JAX's antialiased triangle
    resize along one axis (`compute_weight_mat` with scale out/in, no
    translation): out[o] = sum_i W[i, o] * src[i]."""
    f32 = np.float32
    # jax.image.resize passes the scale as a Python float: 1 / scale is
    # taken in float64 and enters the fp32 arithmetic as a constant
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, f32(1.0))  # antialias: widen
    # (o + 0.5) * inv_scale - 0.5 as one fused multiply-add, as XLA emits
    # it: the product of two fp32 values is exact in float64, so one
    # rounding to fp32 after the subtraction gives the fused result
    centers = np.arange(out_size, dtype=f32) + f32(0.5)
    sample_f = (centers.astype(np.float64) * np.float64(inv_scale)
                - 0.5).astype(f32)
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights_on(in_size: int, out_size: int, device: torch.device):
    """`resize_weights` on `device`, copied there once per shape."""
    return torch.from_numpy(resize_weights(in_size, out_size)).to(device)


def resize_shorter_side(images, size: int = 256):
    """torchvision Resize(size, antialias=True) on a (B, H, W, C) float
    batch: the shorter side becomes `size` (the longer one truncated), each
    axis that changes resampled by `resize_weights` as one product."""
    _, h, w, _ = images.shape
    nh, nw = tv_resize_size(h, w, size)
    x = images
    if nh != h:
        wy = _resize_weights_on(h, nh, x.device)
        x = torch.einsum("bhwc,ho->bowc", x, wy)
    if nw != w:
        wx = _resize_weights_on(w, nw, x.device)
        x = torch.einsum("bhwc,wp->bhpc", x, wx)
    return x


def center_crop(images, size: int = 224):
    """The central (size, size) window of a (B, H, W, C) batch; a side
    shorter than `size` is zero-padded first (torchvision pads; BIOSCAN
    never hits this)."""
    _, h, w, _ = images.shape
    if h < size or w < size:
        ph, pw = max(size - h, 0), max(size - w, 0)
        images = torch.nn.functional.pad(
            images, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        _, h, w, _ = images.shape
    top, left = (h - size) // 2, (w - size) // 2
    return images[:, top : top + size, left : left + size]


# XLA folds the division by 255 into a multiply by its fp32 reciprocal; the
# device transform multiplies the same way, so its pixels equal JAX's
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def eval_transform(images_u8, size: int = 224, resize_to: int = 256,
                   normalize: bool = False, pre_cropped: bool = False):
    """ToTensor -> Resize(256) -> CenterCrop(224) [-> CLIP Normalize] on a
    (B, H, W, 3) uint8 batch on its device; float32 out.

    Three branches, as in JAX: `pre_cropped` (the loader already cropped
    (size, size)) only casts and scales; a frame whose shorter side already
    is `resize_to` is cropped as uint8 first and cast after (exact: scaling
    commutes with the slice); anything else is cast, resized and cropped."""
    _, h, w, _ = images_u8.shape
    if pre_cropped:
        if (h, w) != (size, size):
            raise ValueError(
                f"pre_cropped eval batch must be ({size},{size}); got "
                f"{(h, w)}")
        x = images_u8.to(torch.float32) * _INV_255
    elif tv_resize_size(h, w, resize_to) == (h, w) and min(h, w) >= size:
        x = center_crop(images_u8, size).to(torch.float32) * _INV_255
    else:
        x = images_u8.to(torch.float32) * _INV_255
        x = center_crop(resize_shorter_side(x, resize_to), size)
    if normalize:
        x = _normalize_clip(x)
    return x


def eval_transform_auto(images_u8, size: int = 224, **kw):
    """eval_transform with `pre_cropped` inferred from the shape: a
    (B, size, size, 3) uint8 batch can only come from the loader's host
    center crop (its other frames have shorter side >= 256)."""
    pre = images_u8.shape[1] == size and images_u8.shape[2] == size
    return eval_transform(images_u8, size=size, pre_cropped=pre, **kw)


# ------------------------------------------------ device train augmentation
#
# JAX transforms.py:76-372. Each random op is split into a draw (the per-row
# parameters, from an explicit CPU `torch.Generator`) and a pure apply. JAX's
# draws come from its PRNG and cannot be reproduced in torch; its apply
# functions can, given the same parameters.

# the salt of the augmentation stream within a step (JAX folds 0xA06 into
# the step's key, loop.py:585)
AUG_SALT = 0xA06


def aug_generator(step_seed: int) -> torch.Generator:
    """The CPU generator of one step's augmentation draws: seeded from the
    uint32 step seed and `AUG_SALT`, so the draws follow the step seed and
    nothing else."""
    seed = ((int(step_seed) & 0xFFFFFFFF) << 12) | AUG_SALT
    return torch.Generator().manual_seed(seed)


def draw_rrc_boxes(gen: torch.Generator, b: int, h: int, w: int,
                   scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """b RandomResizedCrop boxes (i, j, h, w), each an int64 (b,) tensor:
    torchvision's get_params per row (JAX `_sample_rrc_box`, :76-116): 10
    proposals of area and log-ratio, the first that fits wins; none fits:
    the central crop clamped to the ratio range."""
    area = h * w
    ta = area * (scale[0] + (scale[1] - scale[0])
                 * torch.rand((b, 10), generator=gen))
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    r = torch.exp(lo + (hi - lo) * torch.rand((b, 10), generator=gen))
    u_i, u_j = torch.rand((2, b), generator=gen)
    ws = torch.round(torch.sqrt(ta * r)).to(torch.int64)
    hs = torch.round(torch.sqrt(ta / r)).to(torch.int64)
    valid = (ws > 0) & (ws <= w) & (hs > 0) & (hs <= h)
    sel = valid.to(torch.int8).argmax(dim=1, keepdim=True)  # first valid
    any_valid = valid.any(dim=1)
    w_s = ws.gather(1, sel)[:, 0]
    h_s = hs.gather(1, sel)[:, 0]
    i_s = torch.floor(u_i * (h - h_s + 1).float()).to(torch.int64)
    j_s = torch.floor(u_j * (w - w_s + 1).float()).to(torch.int64)
    in_ratio = w / h
    if in_ratio < ratio[0]:
        w_f, h_f = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h_f, w_f = h, int(round(h * ratio[1]))
    else:
        w_f, h_f = w, h
    i_f, j_f = (h - h_f) // 2, (w - w_f) // 2

    def pick(s, f):
        return torch.where(any_valid, s, torch.full_like(s, f))

    return pick(i_s, i_f), pick(j_s, j_f), pick(h_s, h_f), pick(w_s, w_f)


def interp_weights(starts, sizes, src_extent: int, out_size: int):
    """(B, out_size, src_extent) fp32 weights that crop [start, start +
    size) of each row and resize it to out_size with the antialiased
    triangle filter (JAX `_interp_weights`, :119-143): out[o] =
    sum_h W[o, h] * src[h]."""
    starts = starts.to(torch.float32)[:, None]
    sizes = sizes.to(torch.float32)[:, None]
    o = torch.arange(out_size, dtype=torch.float32,
                     device=starts.device)[None, :]
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, one rounding more than the CPU's true division
    scale = sizes / torch.full_like(sizes, float(out_size))
    src = starts + (o + 0.5) * scale - 0.5  # (B, out)
    support = torch.clamp_min(scale, 1.0)  # triangle half-width (antialias)
    hh = torch.arange(src_extent, dtype=torch.float32,
                      device=starts.device)[None, None, :]
    dist = (hh - src[:, :, None]).abs() / support[:, :, None]
    wgt = torch.clamp_min(1.0 - dist, 0.0)
    inside = ((hh >= starts[:, :, None] - 0.5)
              & (hh <= (starts + sizes)[:, :, None] - 0.5))
    wgt = torch.where(inside, wgt, 0.0)
    return wgt / torch.clamp_min(wgt.sum(dim=-1, keepdim=True), 1e-8)


def _check_no_tf32(x):
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the train augmentation's fp32 products must not run in TF32: "
            "set torch.backends.cuda.matmul.allow_tf32 = False")


def batched_crop_resize(images, boxes, out_size: int):
    """Crop each row's box (i, j, h, w) out of a (B, H, W, C) float batch
    and resize it to (out_size, out_size): two batched products over the
    dense (B, out, H) and (B, out, W) weights (JAX :146-160)."""
    i, j, h, w = (t.to(images.device) for t in boxes)
    b, hh, ww, c = images.shape
    _check_no_tf32(images)
    wy = interp_weights(i, h, hh, out_size)
    wx = interp_weights(j, w, ww, out_size)
    tmp = torch.bmm(wy, images.reshape(b, hh, ww * c))  # (B, o, W*C)
    tmp = tmp.reshape(b, out_size, ww, c).transpose(1, 2)
    out = torch.bmm(wx, tmp.reshape(b, ww, out_size * c))  # (B, p, o*C)
    return out.reshape(b, out_size, out_size, c).transpose(1, 2)


def draw_flips(gen: torch.Generator, b: int):
    """Per-row (horizontal, vertical) flip bits, each (b,) bool."""
    u = torch.rand((2, b), generator=gen)
    return u[0] < 0.5, u[1] < 0.5


def apply_flips(images, do_h, do_v):
    """RandomHorizontalFlip then RandomVerticalFlip with the drawn bits
    (JAX `random_flips`, :171-179)."""
    do_h = do_h.to(images.device)[:, None, None, None]
    do_v = do_v.to(images.device)[:, None, None, None]
    images = torch.where(do_h, images.flip(2), images)
    return torch.where(do_v, images.flip(1), images)


def draw_angles(gen: torch.Generator, b: int, degrees: float = 45.0):
    """Per-row rotation angles in radians, uniform in +-degrees."""
    u = torch.rand(b, generator=gen)
    return (-degrees + 2 * degrees * u) * (math.pi / 180.0)


def host_cos_sin(angles):
    """The rows' (b, 1, 1) fp32 cos and sin, taken on the host: the card's
    differ from the CPU's in the last bit, which moves a sample that lands
    near a half-pixel to a neighbour."""
    a = angles.to(device="cpu", dtype=torch.float32)[:, None, None]
    return torch.cos(a), torch.sin(a)


def rotate_nearest(images, angles):
    """RandomRotation with the drawn angles (JAX `random_rotation`,
    :182-206): NEAREST interpolation (round half to even, as jnp.round),
    expand=False, zero fill, about the center; a per-row gather. The
    sample coordinates are separate fp32 multiplies and adds, so the card
    and the CPU pick the same pixels."""
    return rotate_by(images, *(t.to(images.device)
                               for t in host_cos_sin(angles)))


def rotate_by(images, cos, sin):
    """`rotate_nearest` given the rows' `host_cos_sin`, on the images'
    device already."""
    b, h, w, c = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=images.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=images.device)[None, :]
    # inverse mapping: output (y, x) samples these input coordinates
    sy = cy + (yy - cy) * cos + (xx - cx) * sin
    sx = cx - (yy - cy) * sin + (xx - cx) * cos
    iy = torch.round(sy).to(torch.int64)
    ix = torch.round(sx).to(torch.int64)
    inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)  # (B, H, W)
    out = images.reshape(b, h * w, c).gather(
        1, idx.reshape(b, h * w, 1).expand(-1, -1, c)).reshape(b, h, w, c)
    return torch.where(inb[..., None], out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    c = maxc - minc
    s = torch.where(maxc > 0, c / torch.clamp_min(maxc, 1e-12), 0.0)
    safe_c = torch.clamp_min(c, 1e-12)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    # JAX's % is a floor mod: torch.remainder, not fmod
    h = torch.where(c > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int64), 6)[..., None]

    def choose(*opts):
        return torch.stack(opts, dim=-1).gather(-1, i)[..., 0]

    r = choose(v, q, p, p, t, v)
    g = choose(t, v, v, q, p, p)
    b = choose(p, p, t, v, v, q)
    return torch.stack([r, g, b], dim=-1)


def draw_jitter(gen: torch.Generator, b: int, brightness=0.5, contrast=0.5,
                saturation=0.5, hue=0.5):
    """Per-row ColorJitter factors (brightness, contrast, saturation, hue),
    each (b,)."""
    def uni(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=gen)

    return (uni(max(0, 1 - brightness), 1 + brightness),
            uni(max(0, 1 - contrast), 1 + contrast),
            uni(max(0, 1 - saturation), 1 + saturation),
            uni(-hue, hue))


def color_jitter(images, fb, fc, fs, fh):
    """ColorJitter with the drawn factors (JAX `color_jitter`, :241-278):
    brightness, contrast and saturation as blends, hue as an HSV shift, in
    that fixed order."""
    dev = images.device

    def col(f, n=4):
        return f.to(device=dev, dtype=torch.float32).reshape(
            (-1,) + (1,) * (n - 1))

    def to_gray(z):
        return (0.2989 * z[..., 0] + 0.587 * z[..., 1]
                + 0.114 * z[..., 2])[..., None]

    x = torch.clamp(images * col(fb), 0, 1)
    mean_gray = to_gray(x).mean(dim=(1, 2), keepdim=True)
    x = torch.clamp(mean_gray + col(fc) * (x - mean_gray), 0, 1)
    gray = to_gray(x)
    x = torch.clamp(gray + col(fs) * (x - gray), 0, 1)
    hsv = _rgb_to_hsv(x)
    hue = torch.remainder(hsv[..., 0] + col(fh, 3), 1.0)
    hsv = torch.cat([hue[..., None], hsv[..., 1:]], dim=-1)
    return torch.clamp(_hsv_to_rgb(hsv), 0, 1)


def draw_train_aug(step_seed: int, b: int, frame_hw, size: int = 224,
                   resize_to: int = 256, jitter: bool = False) -> dict:
    """Every per-row parameter of one step's train augmentation for a
    global batch of b rows of (H, W) frames, from `aug_generator(step_seed)`:
    boxes on the shorter-side-`resize_to` frame, flip bits and angles (none
    for (size, size) frames, which the host already augmented), and the
    jitter factors when `jitter`. Row r's parameters depend on the step seed
    and b only: a microbatch or chunk takes its rows with `aug_rows`."""
    gen = aug_generator(step_seed)
    h, w = frame_hw
    aug = {}
    if (h, w) != (size, size):
        rh, rw = tv_resize_size(h, w, resize_to)
        aug["boxes"] = draw_rrc_boxes(gen, b, rh, rw)
        aug["flips"] = draw_flips(gen, b)
        aug["angles"] = draw_angles(gen, b)
    if jitter:
        aug["jitter"] = draw_jitter(gen, b)
    return aug


def draws_to_device(aug, device):
    """A draw of `draw_train_aug` as the device applies take it: every
    parameter on `device` (from pinned memory, without waiting for the
    card), the angles as their `host_cos_sin` under "rot". A draw already
    on `device` moves nothing, so the apply makes no host-to-device copy
    and a CUDA graph can capture it."""
    if aug is None:
        return None
    device = torch.device(device)
    aug = dict(aug)
    if "angles" in aug:
        aug["rot"] = host_cos_sin(aug.pop("angles"))

    def move(t):
        if t.device.type == "cpu" and device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    return {k: tuple(map(move, v)) if isinstance(v, tuple) else move(v)
            for k, v in aug.items()}


def aug_rows(aug, rows: slice):
    """The parameters of rows `rows` of a batch's draw (None: none)."""
    if aug is None:
        return None
    return {k: tuple(t[rows] for t in v) if isinstance(v, tuple)
            else v[rows] for k, v in aug.items()}


def train_transform(images_u8, aug: dict, size: int = 224,
                    resize_to: int = 256, normalize: bool = False,
                    jitter: bool = False, pre_cropped: bool = False):
    """ToTensor -> Resize(256) -> RandomResizedCrop(224) -> HFlip -> VFlip
    -> RandomRotation(+-45) [-> ColorJitter] on a (B, H, W, 3) uint8 batch
    on its device, with the parameters `aug` (`draw_train_aug`); float32
    out (JAX `train_transform`, :316-351). OpenCLIP's Normalize comes
    before the flips, as in the reference. `pre_cropped`: the host already
    did the geometric part (`host_train_augment`), so only the cast,
    normalize and jitter remain."""
    aug = draws_to_device(aug, images_u8.device)
    x = images_u8.to(torch.float32) * _INV_255
    if not pre_cropped:
        x = batched_crop_resize(resize_shorter_side(x, resize_to),
                                aug["boxes"], size)
    if normalize:
        x = _normalize_clip(x)
    if not pre_cropped:
        x = rotate_by(apply_flips(x, *aug["flips"]), *aug["rot"])
    if jitter:
        x = color_jitter(x, *aug["jitter"])
    return x


def train_transform_auto(images, aug=None, size: int = 224,
                         normalize: bool = False, jitter: bool = False):
    """The train image input on the images' device. A float batch passes
    through; a uint8 batch goes through `train_transform`, `pre_cropped`
    when its frames are (size, size) (the host augmented them: the
    loader's `train_crop`). `aug`: the batch's `draw_train_aug`, needed
    unless the frames are pre-cropped and there is no jitter."""
    if images.dtype != torch.uint8:
        return images
    pre = tuple(images.shape[1:3]) == (size, size)
    return train_transform(images, aug or {}, size=size, normalize=normalize,
                           jitter=jitter, pre_cropped=pre)


def host_random_resized_crop(img: np.ndarray, rng, size: int = 224,
                             resize_to: int = 256, scale=(0.08, 1.0),
                             ratio=(3 / 4, 4 / 3)):
    """Host Resize(256) -> RandomResizedCrop(224) with cv2 and a numpy
    Generator (JAX :375-419): torchvision's get_params (10 proposals, first
    valid wins, central ratio-clamped fallback). (size, size, 3) uint8."""
    import cv2

    h0, w0 = img.shape[:2]
    nh, nw = tv_resize_size(h0, w0, resize_to)
    if (nh, nw) != (h0, w0):
        interp = cv2.INTER_AREA if nh < h0 else cv2.INTER_LINEAR
        img = cv2.resize(img, (nw, nh), interpolation=interp)
    h, w = nh, nw
    area = h * w
    i = j = ch = cw = None
    for _ in range(10):
        ta = area * rng.uniform(scale[0], scale[1])
        r = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        pw = int(round(math.sqrt(ta * r)))
        ph = int(round(math.sqrt(ta / r)))
        if 0 < pw <= w and 0 < ph <= h:
            i = int(rng.integers(0, h - ph + 1))
            j = int(rng.integers(0, w - pw + 1))
            ch, cw = ph, pw
            break
    if i is None:  # central fallback clamped to the ratio range
        in_ratio = w / h
        if in_ratio < ratio[0]:
            cw, ch = w, int(round(w / ratio[0]))
        elif in_ratio > ratio[1]:
            ch, cw = h, int(round(h * ratio[1]))
        else:
            cw, ch = w, h
        i, j = (h - ch) // 2, (w - cw) // 2
    crop = img[i : i + ch, j : j + cw]
    out = cv2.resize(crop, (size, size), interpolation=cv2.INTER_LINEAR)
    return np.ascontiguousarray(out, dtype=np.uint8)


def host_rotate_nearest(img: np.ndarray, angle_deg: float):
    """RandomRotation on the host (JAX :422-432): NEAREST, expand=False,
    zero fill, about the center."""
    import cv2

    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D(((w - 1) / 2.0, (h - 1) / 2.0), angle_deg,
                                1.0)
    return cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_NEAREST,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=0)


def host_train_augment(img: np.ndarray, rng, size: int = 224,
                       resize_to: int = 256, degrees: float = 45.0):
    """The whole geometric train augmentation on the host, the reference's
    CPU-worker transform (JAX :435-465): Resize(256) ->
    RandomResizedCrop(224) -> HFlip -> VFlip -> RandomRotation(+-45,
    NEAREST). (size, size, 3) uint8; the device then only casts,
    normalizes and jitters (`train_transform(pre_cropped=True)`)."""
    out = host_random_resized_crop(img, rng, size=size, resize_to=resize_to)
    if rng.random() < 0.5:
        out = out[:, ::-1]
    if rng.random() < 0.5:
        out = out[::-1]
    angle = float(rng.uniform(-degrees, degrees))
    out = host_rotate_nearest(np.ascontiguousarray(out), angle)
    return np.ascontiguousarray(out, dtype=np.uint8)


def host_resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """Shorter-side resize on the host (cv2: area when shrinking, bilinear
    when growing; the longer side rounded), used only to unify frame shapes
    before batching; the filter-accurate resize runs on the device. cv2 is
    imported only when the frame needs resizing."""
    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    import cv2

    if h <= w:
        nh, nw = size, max(1, int(round(size * w / h)))
    else:
        nh, nw = max(1, int(round(size * h / w))), size
    interp = cv2.INTER_AREA if nh < h else cv2.INTER_LINEAR
    return cv2.resize(img, (nw, nh), interpolation=interp)


def decode_jpeg(buf: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> (H, W, 3) uint8 RGB (cv2 if present, else PIL)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        arr = cv2.imdecode(np.frombuffer(buf, dtype=np.uint8),
                           cv2.IMREAD_COLOR)
        if arr is not None:
            return arr[:, :, ::-1]  # BGR -> RGB
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))

