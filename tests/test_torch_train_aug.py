"""The port's train augmentation (bioscan_clip_tpu_torch/data/transforms.py)
against the JAX package's (bioscan_clip_tpu/data/transforms.py:76-465).

JAX draws its per-row parameters from its PRNG, which torch cannot
reproduce; so each test derives JAX's draws from the same key the JAX
function splits, feeds them to the port's apply functions and compares the
pixels. Tolerances (fp32 on the CPU):
- crop-resize and the whole transform, atol 1e-5: two fp32 products over
  up to ~60 taps summed in another order;
- flips and rotation, exact: index arithmetic on the same fp32 angles;
- color jitter, atol 1e-5: the HSV round trip in another op order;
- the host augmentation, bit for bit: the same cv2 calls on the same
  numpy Generator stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioscan_clip_tpu.data import transforms as jt
from bioscan_clip_tpu_torch.data import transforms as pt
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 4


def _images(seed, shape=(B, 40, 53, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _jax_boxes(key, b, h, w, **kw):
    return jax.jit(jax.vmap(lambda r: jt._sample_rrc_box(r, h, w, **kw)))(
        jax.random.split(key, b))


def _t(boxes):
    return tuple(torch.from_numpy(np.asarray(x).astype(np.int64))
                 for x in boxes)


def test_rrc_boxes_in_bounds_and_the_clamped_fallback():
    gen = torch.Generator().manual_seed(0)
    for h, w in ((256, 341), (256, 256), (341, 256), (30, 200)):
        i, j, bh, bw = pt.draw_rrc_boxes(gen, 512, h, w)
        assert ((i >= 0) & (j >= 0) & (bh > 0) & (bw > 0)).all()
        assert ((i + bh <= h) & (j + bw <= w)).all()
        # the fallback is rare at the default scale; not every box is one
        assert len({(a, b) for a, b in zip(bh.tolist(), bw.tolist())}) > 100
    # no proposal fits (area above the frame's): torchvision's central
    # fallback clamped to the ratio range, as JAX computes it
    for h, w in ((100, 400), (400, 100), (100, 120)):
        got = pt.draw_rrc_boxes(gen, 3, h, w, scale=(2.0, 3.0))
        ref = _jax_boxes(jax.random.PRNGKey(1), 3, h, w, scale=(2.0, 3.0))
        for a, r in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_batched_crop_resize_matches_jax():
    x = _images(1)
    boxes = _jax_boxes(jax.random.PRNGKey(2), B, 40, 53)
    ref = np.asarray(jax.jit(jt.batched_crop_resize, static_argnums=2)(
        jnp.asarray(x), boxes, 24))
    out = pt.batched_crop_resize(torch.from_numpy(x), _t(boxes), 24)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_flips_and_rotation_match_jax_exactly():
    x = _images(3)
    key = jax.random.PRNGKey(4)
    kh, kv = jax.random.split(key)
    do_h = np.array(jax.random.uniform(kh, (B, 1, 1, 1)) < 0.5).ravel()
    do_v = np.array(jax.random.uniform(kv, (B, 1, 1, 1)) < 0.5).ravel()
    ref = np.asarray(jax.jit(jt.random_flips)(jnp.asarray(x), key))
    out = pt.apply_flips(torch.from_numpy(x), torch.from_numpy(do_h),
                         torch.from_numpy(do_v))
    np.testing.assert_array_equal(out.numpy(), ref)

    angles = np.array(jax.random.uniform(key, (B,), minval=-45.0,
                                           maxval=45.0) * (jnp.pi / 180.0))
    ref = np.asarray(jax.jit(jt.random_rotation)(jnp.asarray(x), key))
    out = pt.rotate_nearest(torch.from_numpy(x), torch.from_numpy(angles))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out.numpy() == 0).any()  # the zero fill is exercised


def _jax_jitter(key, b):
    kb, kc, ks, kh = jax.random.split(key, 4)
    return tuple(torch.from_numpy(np.array(f).ravel()) for f in (
        jax.random.uniform(kb, (b, 1, 1, 1), minval=0.5, maxval=1.5),
        jax.random.uniform(kc, (b, 1, 1, 1), minval=0.5, maxval=1.5),
        jax.random.uniform(ks, (b, 1, 1, 1), minval=0.5, maxval=1.5),
        jax.random.uniform(kh, (b, 1, 1), minval=-0.5, maxval=0.5)))


def test_color_jitter_matches_jax():
    x = _images(5)
    key = jax.random.PRNGKey(6)
    ref = np.asarray(jax.jit(jt.color_jitter)(jnp.asarray(x), key))
    out = pt.color_jitter(torch.from_numpy(x), *_jax_jitter(key, B))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def _jax_draws(key, b, frame_hw, size, resize_to):
    """The parameters JAX `train_transform` draws from `key`."""
    k_crop, k_flip, k_rot, k_jit = jax.random.split(key, 4)
    rh, rw = jt.tv_resize_size(*frame_hw, resize_to)
    kh, kv = jax.random.split(k_flip)
    flips = tuple(torch.from_numpy(np.array(
        jax.random.uniform(k, (b, 1, 1, 1)) < 0.5).ravel()) for k in (kh, kv))
    angles = np.array(jax.random.uniform(k_rot, (b,), minval=-45.0,
                                           maxval=45.0) * (jnp.pi / 180.0))
    return {"boxes": _t(_jax_boxes(k_crop, b, rh, rw)), "flips": flips,
            "angles": torch.from_numpy(angles),
            "jitter": _jax_jitter(k_jit, b)}


@pytest.mark.parametrize("normalize,jitter", [(False, False), (True, True)])
def test_train_transform_matches_jax(normalize, jitter):
    u8 = np.random.default_rng(7).integers(0, 256, size=(B, 40, 53, 3),
                                           dtype=np.uint8)
    key = jax.random.PRNGKey(8)
    kw = dict(size=16, resize_to=32, normalize=normalize, jitter=jitter)
    ref = np.asarray(jt.train_transform(jnp.asarray(u8), key, **kw))
    aug = _jax_draws(key, B, (40, 53), 16, 32)
    out = pt.train_transform(torch.from_numpy(u8), aug, **kw)
    assert out.shape == (B, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # a host-augmented (size, size) frame: cast, normalize, jitter only
    pre = u8[:, :16, :16]
    ref = np.asarray(jt.train_transform_auto(jnp.asarray(pre), key, **kw))
    out = pt.train_transform_auto(torch.from_numpy(pre), aug, size=16,
                                  normalize=normalize, jitter=jitter)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_rows_do_not_depend_on_the_cut():
    """A batch's augmented rows equal those of its two halves, each given
    its rows of the batch's draw (row-keyed: the parameters follow the step
    seed and the global row)."""
    u8 = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, size=(B, 40, 53, 3), dtype=np.uint8))
    aug = pt.draw_train_aug(0xBEEF, B, (40, 53), size=16, resize_to=32,
                            jitter=True)
    again = pt.draw_train_aug(0xBEEF, B, (40, 53), size=16, resize_to=32,
                              jitter=True)
    assert torch.equal(aug["angles"], again["angles"])
    kw = dict(size=16, resize_to=32, jitter=True)
    full = pt.train_transform(u8, aug, **kw)
    halves = torch.cat([pt.train_transform(u8[s], pt.aug_rows(aug, s), **kw)
                        for s in (slice(0, B // 2), slice(B // 2, B))])
    assert torch.equal(full, halves)
    other = pt.draw_train_aug(0xBEF0, B, (40, 53), size=16, resize_to=32)
    assert not torch.equal(aug["angles"], other["angles"])
    assert pt.draw_train_aug(1, B, (16, 16), size=16) == {}


def test_host_train_augment_bit_equal_to_jax():
    img = np.random.default_rng(10).integers(0, 256, size=(300, 420, 3),
                                             dtype=np.uint8)
    for seed in range(3):
        ref = jt.host_train_augment(img, np.random.default_rng(seed))
        out = pt.host_train_augment(img, np.random.default_rng(seed))
        assert out.shape == (224, 224, 3) and out.dtype == np.uint8
        np.testing.assert_array_equal(out, ref)
    ref = jt.host_rotate_nearest(img, 17.5)
    np.testing.assert_array_equal(pt.host_rotate_nearest(img, 17.5), ref)
