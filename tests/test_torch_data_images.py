"""The port's image side of the data path against the JAX package: canvases
from ``process_image`` (PIL resize) and ``process_jpeg_file`` (libjpeg decode and the native
resample), ``normalize_canvas_host``, the header reads behind
``predict_canvas_widths``, ``resize_image`` and the image providers.

Each route is held bit for bit to the JAX package's same route (the same
code, or the same C++ built with the same flags). The native resample is
within 2 levels of PIL's resize, the JAX package's own tolerance for it
(``tests/test_native.py``: float accumulation where Pillow uses fixed
point); the host normalization is the same float32 expression.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

import climb_tpu.data.image_backbones as jax_backbones
import climb_tpu.data.image_pipeline as jax_pipe
import climb_tpu.utils.image_utils as jax_image_utils
import climb_tpu_torch.data.image_backbones as backbones
import climb_tpu_torch.data.image_pipeline as pipe
import climb_tpu_torch.native as native
import climb_tpu_torch.utils.image_utils as image_utils
from test_torch_data_common import jax_native_route  # noqa: F401  (fixture)

CANVASES = [(384, 640), (64, 96)]
NATIVE_TO_PIL_LEVELS = 2  # tests/test_native.py's tolerance for the C++ resample
# (h, w): Flickr30k's usual landscape and portrait, COCO, NLVR2-like web sizes,
# a square, a small image that grows, and one already at its resize dims
SIZES = [(375, 500), (500, 375), (480, 640), (333, 500), (683, 1024), (400, 400),
         (40, 70), (384, 512)]


def photo(rng, h, w, mode="RGB"):
    """A smooth image with fine detail: random coarse colour, upsampled, plus noise."""
    coarse = rng.randint(0, 256, size=(max(2, h // 32), max(2, w // 32), 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR)).astype(np.int16)
    img = np.clip(img + rng.randint(-12, 13, size=img.shape), 0, 255).astype(np.uint8)
    return Image.fromarray(img).convert(mode)


def assert_canvas_equal(got, want):
    (gc, gp), (wc, wp) = got, want
    assert gc.dtype == wc.dtype == np.uint8 and gc.shape == wc.shape
    assert tuple(gp) == tuple(wp)
    np.testing.assert_array_equal(gc, wc)


def assert_near_pil(got, pil):
    (gc, gp), (pc, pp) = got, pil
    assert tuple(gp) == tuple(pp)
    assert np.abs(gc.astype(int) - pc.astype(int)).max() <= NATIVE_TO_PIL_LEVELS


@pytest.mark.parametrize("canvas", CANVASES)
def test_process_image_both_routes_bit_equal(canvas, jax_native_route):  # noqa: F811
    rng = np.random.RandomState(0)
    images = [photo(rng, h, w) for h, w in SIZES]
    images += [photo(rng, 300, 420, "L"), photo(rng, 260, 200, "RGBA"),
               np.asarray(photo(rng, 120, 90))]  # a raw array
    pil = [jax_pipe.process_image(im, canvas) for im in images]
    for im, w in zip(images, pil):
        assert_canvas_equal(pipe.process_image(im, canvas), w)


def test_process_jpeg_file_matches_jax(tmp_path, jax_native_route):  # noqa: F811
    rng = np.random.RandomState(1)
    paths = []
    for i, (h, w) in enumerate(SIZES):
        p = tmp_path / f"{i}.jpg"
        photo(rng, h, w).save(p, quality=90)
        paths.append(str(p))
    gray = tmp_path / "gray.jpg"
    photo(rng, 300, 420, "L").save(gray, quality=85)
    paths.append(str(gray))
    assert native.native_available()["jpeg"]
    for canvas in CANVASES:
        for p in paths:
            got = pipe.process_jpeg_file(p, canvas)
            assert got is not None, p
            assert_canvas_equal(got, jax_pipe.process_jpeg_file(p, canvas))
            with Image.open(p) as im:
                assert_near_pil(got, pipe.process_image(im, canvas))
    # a CMYK JPEG is left to PIL, as in the JAX package
    cmyk = tmp_path / "cmyk.jpg"
    photo(rng, 100, 150).convert("CMYK").save(cmyk)
    assert pipe.process_jpeg_file(str(cmyk)) is None
    assert pipe.process_jpeg_file(str(tmp_path / "missing.jpg")) is None


def test_native_jpeg_decode_and_dims_match_pil(tmp_path):
    rng = np.random.RandomState(2)
    for h, w in SIZES[:4]:
        buf = io.BytesIO()
        photo(rng, h, w).save(buf, format="JPEG", quality=92)
        data = buf.getvalue()
        assert native.jpeg_dims(data) == (h, w)
        with Image.open(io.BytesIO(data)) as im:
            np.testing.assert_array_equal(native.decode_jpeg(data), np.asarray(im.convert("RGB")))
    assert native.jpeg_dims(b"not a jpeg") is None
    assert native.decode_jpeg(b"\xff\xd8\xff\xe0garbage") is None


def test_normalize_canvas_host_and_resize_image_match_jax():
    rng = np.random.RandomState(3)
    canvas = rng.randint(0, 256, size=(2, 64, 96, 3)).astype(np.uint8)
    got, want = pipe.normalize_canvas_host(canvas), jax_pipe.normalize_canvas_host(canvas)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    every = np.arange(256, dtype=np.uint8)
    assert np.array_equal(pipe.normalize_canvas_host(every).view(np.int32),
                          jax_pipe.normalize_canvas_host(every).view(np.int32))
    for h, w in SIZES + [(10, 10)]:
        im = photo(rng, h, w)
        for shape in ((384, 640), (640, 384), (64, 96)):
            np.testing.assert_array_equal(image_utils.resize_image(im, shape),
                                          jax_image_utils.resize_image(im, shape))
    assert image_utils.compute_resized_dims(500, 375, 640, 384) == \
        jax_image_utils.compute_resized_dims(500, 375, 640, 384)


def test_header_dims_and_canvas_widths_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    paths = []
    for i, (h, w) in enumerate(SIZES):
        p = tmp_path / (f"{i}.jpg" if i % 2 else f"{i}.png")
        photo(rng, h, w).save(p)
        paths.append(str(p))
    (tmp_path / "broken.jpg").write_bytes(b"\xff\xd8 not really")
    paths.append(str(tmp_path / "broken.jpg"))
    for p in paths:
        assert pipe.image_header_dims(p) == jax_pipe.image_header_dims(p), p
    per_example = [[p] for p in paths] + [paths[:2]]
    cache = tmp_path / "cache" / "image_dims.pkl"
    for canvas in CANVASES:
        want = jax_pipe.predict_canvas_widths(per_example, canvas, cache_path=str(cache))
        # the port reads the cache the JAX package wrote, and agrees without it
        assert np.array_equal(pipe.predict_canvas_widths(per_example, canvas,
                                                         cache_path=str(cache)), want)
        assert np.array_equal(pipe.predict_canvas_widths(per_example, canvas), want)


@pytest.mark.parametrize("visual_input_type", ["pil-image", "raw"])
def test_image_providers_match_jax(tmp_path, visual_input_type, jax_native_route):  # noqa: F811
    rng = np.random.RandomState(5)
    os.makedirs(tmp_path / "flickr" / "flickr30k_images")
    os.makedirs(tmp_path / "coco" / "images")
    for i, (h, w) in enumerate(SIZES[:4]):
        photo(rng, h, w).save(tmp_path / "flickr" / "flickr30k_images" / f"{i + 1}.jpg")
        photo(rng, w, h).save(tmp_path / "coco" / "images" / f"COCO_train2014_{i + 7:012d}.jpg")
    (tmp_path / "flickr" / "flickr30k_images" / "notes.txt").write_text("not an image")
    (tmp_path / "flickr" / "flickr30k_images" / "9.jpg").write_bytes(b"broken")
    for cls, jax_cls, sub in ((backbones.Flickr30KImagesDataset,
                               jax_backbones.Flickr30KImagesDataset, "flickr"),
                              (backbones.MSCOCOImagesDataset,
                               jax_backbones.MSCOCOImagesDataset, "coco")):
        got = cls(str(tmp_path / sub), (64, 96), visual_input_type=visual_input_type)
        want = jax_cls(str(tmp_path / sub), (64, 96), visual_input_type=visual_input_type)
        assert got.imageid2filename == want.imageid2filename
        for image_id in want.imageids:  # the broken file is a black canvas in both
            (gc, gp), (wc, wp) = got.get_image_data(image_id), want.get_image_data(image_id)
            assert gc.dtype == wc.dtype == (np.uint8 if visual_input_type == "pil-image"
                                            else np.float32)
            assert tuple(gp) == tuple(wp) and np.array_equal(gc, wc)
    with pytest.raises(NotImplementedError):
        backbones.CanvasImageProvider(visual_input_type="fast-rcnn")
    with pytest.raises(ValueError):
        backbones.CanvasImageProvider(visual_input_type="bogus")
