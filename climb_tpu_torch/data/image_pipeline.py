"""Host-side image preprocessing to fixed-shape uint8 canvases (the port's
copy of ``climb_tpu/data/image_pipeline.py``).

  decode -> ViLT resize (shortest edge 384, longest <= 640, dims floored to
  /32, bicubic) -> uint8 canvas (top-left anchored) + valid patch dims.

Normalization happens on the card (``ops.image_ops``): the canvas travels as
uint8, four times smaller than float32. The 'raw' visual input normalizes on
the host instead (``normalize_canvas_host``), bit-equal to the card's
float32 result. JPEGs take the native route where its libraries built
(``climb_tpu_torch.native``: libjpeg decode and the C++ resample, within 2
levels of PIL's resize), PIL otherwise, each route bit-equal to the JAX
package's same route.

As in the JAX package, the canvas is a fixed landscape (384, 640); portrait
images are fit to height <= 384 (the reference pads each batch to its own
largest image instead).
"""

from typing import Tuple

import numpy as np


def vilt_resize_dims(
    h: int,
    w: int,
    shorter: int = 384,
    longer: int = 640,
    size_divisor: int = 32,
    max_h: int = 384,
    max_w: int = 640,
) -> Tuple[int, int]:
    """Output (h, w) per ViltImageProcessor.get_resize_output_image_size,
    additionally capped to the fixed canvas."""
    scale = shorter / min(h, w)
    if h < w:
        new_h, new_w = shorter, scale * w
    else:
        new_h, new_w = scale * h, shorter
    if max(new_h, new_w) > longer:
        s = longer / max(new_h, new_w)
        new_h, new_w = new_h * s, new_w * s
    # canvas cap (portrait fit): keeps shapes static
    if new_h > max_h:
        s = max_h / new_h
        new_h, new_w = max_h, new_w * s
    if new_w > max_w:
        s = max_w / new_w
        new_h, new_w = new_h * s, max_w
    new_h, new_w = int(new_h + 0.5), int(new_w + 0.5)
    new_h = max(size_divisor, new_h // size_divisor * size_divisor)
    new_w = max(size_divisor, new_w // size_divisor * size_divisor)
    return new_h, new_w


def normalize_canvas_host(canvas_u8: np.ndarray) -> np.ndarray:
    """uint8 canvas -> normalized float32 in [-1, 1] on the host.

    The 'raw' ``visual_input_type`` variant (reference
    cocoimages_dataset.py:47-51: Resize + ToTensor + Normalize(0.5, 0.5) at
    load time). The op order matches ``ops.image_ops.normalize_images`` (and ``csrc/normalize.cu``)
    exactly so host- and device-normalized pixels are bit-identical in f32.
    """
    x = canvas_u8.astype(np.float32) * np.float32(1.0 / 255.0)
    return (x - np.float32(0.5)) / np.float32(0.5)


def image_header_dims(path: str):
    """(h, w) of an image file from its header only — no pixel decode.

    Used by aspect bucketing to predict each example's resized canvas width
    ahead of loading. JPEGs go through the native header parser; everything
    else (and truncated-header fallback) uses PIL's lazy open, which reads
    metadata without decoding. Returns None when unreadable.
    """
    try:
        if path.lower().endswith((".jpg", ".jpeg")):
            from climb_tpu_torch.native import jpeg_dims

            with open(path, "rb") as f:
                head = f.read(65536)
            dims = jpeg_dims(head)
            if dims is not None:
                return dims
        from PIL import Image

        with Image.open(path) as im:
            return im.height, im.width
    except Exception:
        return None


def predict_canvas_widths(paths_per_example, canvas_hw, cache_path=None,
                          memo=None):
    """Per-example needed canvas width (pixels) from image headers only —
    the aspect-bucketing hint. Applies the same ViLT resize rule the loading
    pipeline uses, so predictions match the loaded ``patch_hw`` exactly;
    unreadable headers conservatively claim the full canvas. ``memo`` (a
    path->dims dict) is updated in place; new entries are persisted to
    ``cache_path`` when given."""
    from climb_tpu_torch.data.cache import load_pickle_cache, save_pickle_cache

    if memo is None:
        memo = {}
    if cache_path and not memo:
        memo.update(load_pickle_cache(cache_path, tolerant=True) or {})
    ch, cw = canvas_hw
    new = 0
    widths = np.empty((len(paths_per_example),), np.int64)
    for i, paths in enumerate(paths_per_example):
        w = 0
        for path in paths:
            if path not in memo:
                memo[path] = image_header_dims(path)
                new += 1
            dims = memo[path]
            if dims is None:
                w = max(w, cw)
            else:
                _, nw = vilt_resize_dims(dims[0], dims[1], max_h=ch, max_w=cw)
                w = max(w, nw)
        widths[i] = w
    if new and cache_path:
        save_pickle_cache(cache_path, memo)
    return widths


def process_image(
    image,
    canvas_hw: Tuple[int, int] = (384, 640),
    patch_size: int = 32,
    resample: str = "bicubic",
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """PIL image / HxWxC array -> (uint8 canvas (H,W,3), patch_hw).

    patch_hw = (valid_h // patch, valid_w // patch) — resize dims are always
    multiples of patch_size so the valid region tiles exactly.
    """
    from PIL import Image

    ch, cw = canvas_hw
    if not hasattr(image, "mode"):  # raw array (note ndarray HAS .size)
        image = Image.fromarray(np.asarray(image).astype(np.uint8))
    if image.mode != "RGB":
        image = image.convert("RGB")
    w, h = image.size
    nh, nw = vilt_resize_dims(h, w, max_h=ch, max_w=cw)

    if (nh, nw) != (h, w):
        filt = Image.BICUBIC if resample == "bicubic" else Image.BILINEAR
        image = image.resize((nw, nh), resample=filt)
    arr = np.asarray(image, dtype=np.uint8)
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[:nh, :nw] = arr[:, :, :3]
    return canvas, (nh // patch_size, nw // patch_size)


def process_jpeg_file(
    path: str,
    canvas_hw: Tuple[int, int] = (384, 640),
    patch_size: int = 32,
):
    """Fully-native JPEG -> canvas path: C++ libjpeg decode at full scale
    (native/jpeg_decode.cpp) + C++ bicubic resample, within 2 levels of PIL's
    (native/image_ops.cpp). Returns None when the native libraries are
    unavailable or the file needs PIL (e.g. CMYK) — callers fall back to
    ``process_image``.
    """
    from climb_tpu_torch.native import decode_jpeg, jpeg_dims, resize_into_canvas

    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    dims = jpeg_dims(data)
    if dims is None:
        return None
    h, w = dims
    if h < 1 or w < 1:
        return None
    ch, cw = canvas_hw
    nh, nw = vilt_resize_dims(h, w, max_h=ch, max_w=cw)

    img = decode_jpeg(data)
    if img is None:
        return None
    if img.shape[:2] == (nh, nw):
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:nh, :nw] = img
        return canvas, (nh // patch_size, nw // patch_size)
    canvas = resize_into_canvas(img, (nh, nw), (ch, cw), "bicubic")
    if canvas is None:
        return None
    return canvas, (nh // patch_size, nw // patch_size)
