"""The port's native decode/resample library against the JAX package's, on
the CPU: both are built from the same C++ code (the port's copy in
``ml_autofocusformermod_torch/native/src``, built into its own
``native/build/``), so every output must agree bit for bit: JPEG header
dims, decode + crop + resample (bilinear and bicubic, with and without the
DCT-domain downscale, flipped or not), the in-memory resampler, each
RandAugment op, and the failure on bytes that are no JPEG."""

import io

import numpy as np
import pytest
from PIL import Image

from ml_autofocusformermod_torch.data import native_jpeg as port_nj
from ml_autofocusformermod_torch.data.transforms import RA_OP_IDS
from ml_autofocusformermod_tpu.data import native_jpeg as jax_nj


def _photo(w, h, seed):
    """A smooth synthetic photo with a little noise."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 17, w)
    y = np.linspace(0, 11, h)
    r = np.sin(x)[None, :] * np.cos(y)[:, None] * 0.5 + 0.5
    g = np.cos(2 * x)[None, :] * np.sin(0.5 * y)[:, None] * 0.5 + 0.5
    b = (x[None, :] / x.max() + y[:, None] / y.max()) / 2
    img = np.stack([r, g, b], -1) * 230 + rng.uniform(0, 25, (h, w, 3))
    return Image.fromarray(img.astype(np.uint8))


def _jpeg(img, quality=90):
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


IMAGES = {
    "500x375": _jpeg(_photo(500, 375, 0)),
    "375x500": _jpeg(_photo(375, 500, 1)),
    "320x240_gray": _jpeg(_photo(320, 240, 2).convert("L")),
}


def test_port_library_builds_into_its_own_directory():
    assert port_nj.available(), port_nj.build_info()
    info = port_nj.build_info()
    assert info["ok"] and info["path"].startswith(str(port_nj.BUILD_DIR))
    assert jax_nj.available()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_jpeg_dims_match_jax(name):
    data = IMAGES[name]
    assert port_nj.jpeg_dims(data) == jax_nj.jpeg_dims(data)
    assert port_nj.jpeg_dims(data) == Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("fast_scale", [False, True])
def test_decode_crop_resize_matches_jax(interp, fast_scale):
    for name, data in IMAGES.items():
        w, h = port_nj.jpeg_dims(data)
        for box, flip in [((0.0, 0.0, float(w), float(h)), False),
                          ((37.0, 22.0, 211.0, 180.0), True),
                          ((w - 69.0, h - 75.0, 69.0, 75.0), False),
                          ((12.5, 7.25, 100.75, 150.5), True)]:
            for out in [(224, 224), (56, 40)]:
                got = port_nj.decode_crop_resize(
                    data, box, out, flip=flip, interpolation=interp,
                    fast_scale=fast_scale)
                want = jax_nj.decode_crop_resize(
                    data, box, out, flip=flip, interpolation=interp,
                    fast_scale=fast_scale)
                assert got is not None and got.shape == (out[1], out[0], 3)
                np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_resample_rgb_matches_jax(interp):
    arr = np.asarray(_photo(300, 200, 3))
    for box, flip in [((0.0, 0.0, 300.0, 200.0), False),
                      ((31.0, 17.5, 150.0, 121.0), True)]:
        got = port_nj.resample_rgb(arr, box, (112, 96), flip=flip,
                                   interpolation=interp)
        want = jax_nj.resample_rgb(arr, box, (112, 96), flip=flip,
                                   interpolation=interp)
        np.testing.assert_array_equal(got, want)


_RA_PARAMS = {
    "rotate": [17.3, -8.0], "posterize_inc": [2], "solarize_inc": [120],
    "solarize_add": [70], "color": [0.4, 1.7], "contrast": [0.4, 1.7],
    "brightness": [0.4, 1.7], "sharpness": [0.3, 1.8],
    "shear_x": [0.22, -0.1], "shear_y": [0.22], "translate_x": [40.5, -33.25],
    "translate_y": [40.5], "auto_contrast": [0.0], "equalize": [0.0],
    "invert": [0.0],
}


@pytest.mark.parametrize("op", sorted(RA_OP_IDS))
def test_randaugment_op_matches_jax(op):
    base = np.ascontiguousarray(np.asarray(_photo(96, 80, 4)))
    for p in _RA_PARAMS[op]:
        got, want = base.copy(), base.copy()
        assert port_nj.randaugment_inplace(got, [RA_OP_IDS[op]], [float(p)])
        assert jax_nj.randaugment_inplace(want, [RA_OP_IDS[op]], [float(p)])
        np.testing.assert_array_equal(got, want)
    # a two-op plan, as RandAugment draws them
    got, want = base.copy(), base.copy()
    ids, ps = [RA_OP_IDS[op], RA_OP_IDS["rotate"]], [_RA_PARAMS[op][0], 9.0]
    assert port_nj.randaugment_inplace(got, ids, ps)
    assert jax_nj.randaugment_inplace(want, ids, ps)
    np.testing.assert_array_equal(got, want)


def test_bad_bytes_give_none():
    assert port_nj.jpeg_dims(b"not a jpeg") is None
    assert port_nj.decode_crop_resize(b"junkjunkjunk", (0, 0, 8, 8),
                                      (16, 16)) is None
    truncated = IMAGES["500x375"][:200]
    assert port_nj.decode_crop_resize(truncated, (0, 0, 100, 100),
                                      (16, 16)) is None
    png = io.BytesIO()
    _photo(40, 30, 5).save(png, "PNG")
    assert port_nj.jpeg_dims(png.getvalue()) is None
