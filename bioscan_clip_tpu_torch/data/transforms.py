"""Eval image preprocessing, on the host (torchvision-exact, numpy) and on
the device (batched tensors), and the train-time image input on the device.

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

`train_transform_auto` is the `pre_cropped` branch of the JAX
`train_transform_auto` (transforms.py:316-372): a (B, 224, 224, 3) uint8
batch that the loader already augmented on the host is scaled to [0, 1] on
the device, then CLIP-normalized for OpenCLIP towers.
"""

from __future__ import annotations

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


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


def resize_shorter_side(images, size: int = 256):
    """torchvision Resize(size, antialias=True) on a (B, H, W, C) float
    batch: the shorter side becomes `size` (the longer one truncated), each
    axis that changes resampled by `resize_weights` as one product."""
    _, h, w, _ = images.shape
    nh, nw = tv_resize_size(h, w, size)
    x = images
    if nh != h:
        wy = torch.from_numpy(resize_weights(h, nh)).to(x.device)
        x = torch.einsum("bhwc,ho->bowc", x, wy)
    if nw != w:
        wx = torch.from_numpy(resize_weights(w, nw)).to(x.device)
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
        mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
        x = (x - mean) / std
    return x


def eval_transform_auto(images_u8, size: int = 224, **kw):
    """eval_transform with `pre_cropped` inferred from the shape: a
    (B, size, size, 3) uint8 batch can only come from the loader's host
    center crop (its other frames have shorter side >= 256)."""
    pre = images_u8.shape[1] == size and images_u8.shape[2] == size
    return eval_transform(images_u8, size=size, pre_cropped=pre, **kw)


def train_transform_auto(images, size: int = 224, normalize: bool = False):
    """The train image input on the images' device. A float batch passes
    through; a (B, size, size, 3) uint8 batch (host-augmented and cropped)
    becomes float32 / 255 [-> CLIP normalize]. Any other uint8 frame needs
    the device-side geometric augmentation, which is not ported yet."""
    if images.dtype != torch.uint8:
        return images
    if tuple(images.shape[1:]) != (size, size, 3):
        raise NotImplementedError(
            f"a uint8 train batch of {tuple(images.shape[1:])} needs the "
            "device-side geometric augmentation (Resize, RandomResizedCrop, "
            "flips, rotation), which is not ported yet: ROADMAP.md queue 1; "
            f"feed host-augmented ({size}, {size}, 3) frames")
    x = images.to(torch.float32) / 255.0
    if normalize:
        mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
        x = (x - mean) / std
    return x


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

