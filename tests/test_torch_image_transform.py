"""Image augmentation and the host library binding in the port against the
JAX package.

The batched flip and crop are device functions on torch tensors in the
port, each a draw and a deterministic apply: fed the flips and offsets that
``jax.random`` draws inside the JAX package's ``batch_random_flip`` /
``batch_random_crop``, the port's apply must give JAX's images exactly.
The per-image transforms are the JAX package's numpy code and must agree
bit for bit on the same image and seed. ``native.py`` is the port's own
binding of the same C++ library: each function must equal the JAX
binding's on one build of it, and through the numpy fallback."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import image_transform as jimg

from deeplearning4j_tpu_torch.data import image_transform as pimg

from torch_native_helpers import shared_native_library  # noqa: F401  (autouse)


def _images(n=5, c=3, h=9, w=11, seed=0):
    return np.random.RandomState(seed).rand(n, c, h, w).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flip_at_jax_draws(seed):
    x = _images()
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jimg.batch_random_flip(jnp.asarray(x), key))
    flips = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.5, (x.shape[0],))))
    got = pimg.apply_flips(torch.from_numpy(x), flips)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("size", [(9, 11), (4, 7), (1, 1)])
def test_crop_at_jax_draws(seed, size):
    x = _images()
    height, width = size
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jimg.batch_random_crop(jnp.asarray(x), key, height, width))
    k1, k2 = jax.random.split(key)
    tops = jax.random.randint(k1, (x.shape[0],), 0, x.shape[2] - height + 1)
    lefts = jax.random.randint(k2, (x.shape[0],), 0, x.shape[3] - width + 1)
    got = pimg.apply_crops(torch.from_numpy(x), torch.from_numpy(np.array(tops)),
                           torch.from_numpy(np.array(lefts)), height, width)
    assert tuple(got.shape) == (5, 3, height, width)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_flip_and_crop_draws_are_seeded_and_in_range():
    x = torch.from_numpy(_images(n=64, h=12, w=12))
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = pimg.batch_random_crop(pimg.batch_random_flip(x, g1), g1, 8, 8)
    b = pimg.batch_random_crop(pimg.batch_random_flip(x, g2), g2, 8, 8)
    assert torch.equal(a, b) and tuple(a.shape) == (64, 3, 8, 8)
    flips = pimg.draw_flips(4000, torch.Generator().manual_seed(0))
    assert abs(float(flips.float().mean()) - 0.5) < 0.03
    tops, lefts = pimg.draw_crop_offsets(4000, 12, 10, 8, 8, torch.Generator().manual_seed(1))
    assert set(tops.tolist()) == set(range(5)) and set(lefts.tolist()) == set(range(3))
    # uint8 pixels pass through unchanged in value
    u8 = torch.randint(0, 256, (2, 3, 6, 6), dtype=torch.uint8)
    out = pimg.apply_crops(pimg.apply_flips(u8, torch.tensor([True, False])),
                           torch.tensor([0, 2]), torch.tensor([1, 0]), 4, 4)
    assert out.dtype == torch.uint8
    assert torch.equal(out[1], u8[1, :, 2:6, 0:4])
    assert torch.equal(out[0], torch.flip(u8[0], dims=(-1,))[:, 0:4, 1:5])


@pytest.mark.parametrize("make", [
    lambda m: m.FlipImageTransform(mode=None),
    lambda m: m.CropImageTransform(top=1, left=2, bottom=1, right=0),
    lambda m: m.RandomCropTransform(height=5, width=6),
    lambda m: m.RotateImageTransform(angle=90.0),
    lambda m: m.RotateImageTransform(angle=17.0, random=True),
    lambda m: m.ResizeImageTransform(height=12, width=7),
    lambda m: m.BrightnessTransform(delta=0.1),
    lambda m: m.PipelineImageTransform((m.FlipImageTransform(mode=None), 0.5),
                                       m.RandomCropTransform(height=6, width=6), shuffle=True),
], ids=["flip", "crop", "random-crop", "rot90", "rotate", "resize", "brightness", "pipeline"])
def test_per_image_transforms_match_jax(make):
    img = np.random.RandomState(4).rand(9, 10, 3).astype(np.float32)
    for seed in range(3):
        want = make(jimg).call(img.copy(), np.random.RandomState(seed))
        got = make(pimg).call(img.copy(), np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# native.py
# ---------------------------------------------------------------------------


@pytest.fixture
def libs(shared_native_library):
    if shared_native_library is None:
        pytest.skip("no C++ compiler for the host library")
    return shared_native_library


def _fallback(mod, fn, *args, **kw):
    saved, tried = mod._lib, mod._tried
    mod._lib, mod._tried = None, True
    os.environ["DL4J_TPU_DISABLE_NATIVE"] = "1"
    try:
        return fn(*args, **kw)
    finally:
        del os.environ["DL4J_TPU_DISABLE_NATIVE"]
        mod._lib, mod._tried = saved, tried


def _calls():
    rs = np.random.RandomState(5)
    grad = (rs.randn(500) * 0.01).astype(np.float32)
    img = rs.rand(7, 5, 3).astype(np.float32)
    idx = (bytes([0, 0, 0x08, 3]) + (2).to_bytes(4, "big") + (3).to_bytes(4, "big")
           + (2).to_bytes(4, "big") + bytes(range(12)))
    ppm = b"P6\n# c\n4 3\n255\n" + bytes(range(36))
    return {
        "threshold_encode": lambda m: (m.threshold_encode(g := grad.copy(), 0.012), g),
        "threshold_decode": lambda m: m.threshold_decode(
            m.threshold_encode(grad.copy(), 0.012), 0.012, t := np.zeros(500, np.float32)) or t,
        "bitmap_encode": lambda m: (m.bitmap_encode(g := grad.copy(), 0.01), g),
        "parse_csv": lambda m: m.parse_csv(b"a,b\n1.5,2\n-4,6e2\n", skip_rows=1),
        "parse_idx": lambda m: m.parse_idx(idx, scale=1 / 255.0),
        "decode_netpbm": lambda m: m.decode_netpbm(ppm),
        "resize_bilinear": lambda m: m.resize_bilinear(img, 14, 10),
        "normalize_hwc": lambda m: m.normalize_hwc(img.copy(), [0.4, 0.5, 0.6], [0.2, 0.3, 0.25]),
    }


def _same(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(_calls()))
def test_native_matches_jax_binding(libs, name):
    jn, pn = libs
    call = _calls()[name]
    _same(call(jn), call(pn))
    _same(_fallback(jn, call, jn), _fallback(pn, call, pn))


def test_native_available_and_build_dir_is_ignored(libs):
    _, pn = libs
    assert pn.available()
    with open(os.path.join(os.path.dirname(pn._PKG_DIR), ".gitignore")) as f:
        ignored = f.read().split()
    assert "deeplearning4j_tpu_torch/_build/" in ignored and "native/build/" in ignored
