"""Host-side image preprocessing to fixed-shape uint8 canvases (the port's
copy of ``climb_tpu/data/image_pipeline.py``'s ``vilt_resize_dims`` and
``process_image``):

  ViLT resize (shortest edge 384, longest <= 640, dims floored to /32,
  bicubic) -> uint8 canvas (top-left anchored) + valid patch dims.

Normalization happens on the device (``ops.image_ops``). The native C++
resampler that the JAX package falls back to is not ported: PIL does the
resize, and its errors propagate.
"""

from typing import Tuple

import numpy as np


def vilt_resize_dims(h: int, w: int, shorter: int = 384, longer: int = 640,
                     size_divisor: int = 32, max_h: int = 384,
                     max_w: int = 640) -> Tuple[int, int]:
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


def process_image(image, canvas_hw: Tuple[int, int] = (384, 640), patch_size: int = 32,
                  resample: str = "bicubic") -> Tuple[np.ndarray, Tuple[int, int]]:
    """PIL image or HxWxC array -> (uint8 canvas (H, W, 3), patch_hw), with
    patch_hw = (valid_h // patch, valid_w // patch): the resize dims are
    multiples of patch_size, so the valid region tiles exactly."""
    from PIL import Image

    ch, cw = canvas_hw
    if not hasattr(image, "mode"):  # a raw array (an ndarray has .size too)
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
