"""Host-side image resize/pad helpers (the port's copy of
``climb_tpu/utils/image_utils.py``).

Parity: reference ``src/utils/image_utils.py:7-59`` (``resize_image``):
aspect-preserving downscale into a landscape ``(min(shape), max(shape))``
canvas, top-left anchored zero padding, CMYK->RGB conversion, grayscale
channel stacking, and (documented quirk) returning an all-black canvas on any
decoding exception (``image_utils.py:55-59``).

These functions are numpy-based and run on the host input pipeline; the
normalization on the card lives in ``climb_tpu_torch.ops.image_ops``, the C++
fast path in ``climb_tpu_torch.native``.
"""

import logging
from typing import Tuple

import numpy as np

logger = logging.getLogger(__name__)


def compute_resized_dims(w: int, h: int, d_w: int, d_h: int) -> Tuple[int, int]:
    """New (w, h) for an aspect-preserving fit into a (d_w, d_h) canvas.

    Mirrors the branch structure of the reference ``resize_image``: landscape
    images target (d_w, d_h) = (max, min) of the canvas, portrait images the
    transpose; images already smaller than the canvas are only shrunk if one
    side still exceeds the canvas.
    """
    if w > h:
        if w >= d_w:
            new_h = int(h * d_w / w)
            if new_h > d_h:
                return int(w * d_h / h), d_h
            return d_w, new_h
        if h > d_h:
            return int(d_h * w / h), d_h
        return w, h
    else:
        # Portrait/square: the reference swaps canvas orientation.
        d_w, d_h = d_h, d_w  # noqa: intended swap — canvas follows orientation
        if h >= d_h:
            new_w = int(w * d_h / h)
            if new_w > d_w:
                return d_w, int(h * d_w / w)
            return new_w, d_h
        if w > d_w:
            return d_w, int(d_w * h / w)
        return w, h


def to_rgb_array(image) -> np.ndarray:
    """PIL image (or ndarray) -> HxWx3 uint8 array, handling CMYK/gray/alpha."""
    if hasattr(image, "mode"):
        if image.mode in ("CMYK", "P", "LA", "RGBA"):
            image = image.convert("RGB")
        arr = np.asarray(image)
    else:
        arr = np.asarray(image)
    if arr.ndim < 3:
        arr = np.stack((arr,) * 3, axis=-1)
    elif arr.shape[2] > 3:
        arr = arr[:, :, :3]
    return arr


def resize_image(image, desired_shape: Tuple[int, int]) -> np.ndarray:
    """Resize + zero-pad an image into a (min(shape), max(shape)) HxWx3 canvas.

    Returns a float64 array shaped (d_h, d_w, 3) with the resized image in the
    top-left corner, matching the reference's ``resize_image`` semantics
    (including the nearest-neighbour ``resample=0`` resize and the silent
    black-canvas fallback on error).
    """
    d_w = max(desired_shape)
    d_h = min(desired_shape)
    try:
        w, h = image.size
        if image.mode == "CMYK":
            image = image.convert("RGB")
        new_w, new_h = compute_resized_dims(w, h, d_w, d_h)
        if (new_w, new_h) != (w, h):
            image = image.resize((new_w, new_h), resample=0)  # nearest, like ref

        arr = to_rgb_array(image)
        padded = np.zeros((d_h, d_w, 3), dtype=np.float64)
        padded[: arr.shape[0], : arr.shape[1]] = arr[:d_h, :d_w]
        return padded
    except Exception as e:  # reference behavior: swallow and return black
        logger.warning("resize_image failed (%s); returning black canvas", e)
        return np.zeros((d_h, d_w, 3), dtype=np.float64)
