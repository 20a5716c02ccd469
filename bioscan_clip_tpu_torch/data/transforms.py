"""Host-side eval image preprocessing, torchvision-exact, in numpy, and the
train-time image input on the device.

Copies of the host eval half of bioscan_clip_tpu/data/transforms.py
(`tv_resize_size` :34-41, `_pil_triangle_weights`, `host_antialias_resize`
and `host_eval_image` :467-533) and of `_decode_jpeg`
(bioscan_clip_tpu/data/pipeline.py:32-45). The eval pipeline (reference
dataset.py:194-200: ToTensor -> Resize(256, antialias=True) ->
CenterCrop(224)) runs bit-faithfully on the host in float32: torchvision's
antialias resize is PIL's separable triangle filter on floats, and so is
this. The JAX package's device-side batched transform (`eval_transform`,
served with `image_host_parity=False`) comes in a later slice.

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

