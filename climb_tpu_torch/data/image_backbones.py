"""Image providers (the port's copy of ``climb_tpu/data/image_backbones.py``;
reference ``src/data/image_datasets/``).

``MSCOCOImagesDataset`` (cocoimages_dataset.py) and ``Flickr30KImagesDataset``
(flickr30kimages_dataset.py) map image ids to files. Instead of PIL images
that the model re-processes every step, they return fixed-shape canvases and
valid patch dims (``climb_tpu_torch.data.image_pipeline``), computed in the
loader's workers.
"""

import logging
import os
from typing import Dict, Tuple

import numpy as np

from climb_tpu_torch.data.image_pipeline import (
    normalize_canvas_host,
    process_image,
    process_jpeg_file,
)

logger = logging.getLogger(__name__)

# Reference cocoimages_dataset.py:37: {'pil-image', 'raw', 'fast-rcnn'}.
# 'pil-image' here is the uint8 canvas, normalized on the card; 'raw' is the
# float32 canvas normalized on the host, the reference raw path's
# normalize-at-load-time semantics (cocoimages_dataset.py:47-51). Its pixel
# geometry is that of 'pil-image' (the aspect-preserving bicubic padded
# canvas, where the reference's raw path squash-resizes with bilinear), so
# 'raw' gives the model bit-identical inputs to 'pil-image'. 'fast-rcnn'
# raises NotImplementedError in the reference itself
# (cocoimages_dataset.py:60-69) and stays that way.
VISUAL_INPUT_TYPES = ("pil-image", "raw")


class CanvasImageProvider:
    """Base: id -> (canvas, patch_hw). Canvas dtype follows
    ``visual_input_type``: uint8 for 'pil-image', normalized f32 for 'raw'."""

    def __init__(self, canvas_hw: Tuple[int, int] = (384, 640), patch_size: int = 32,
                 visual_input_type: str = "pil-image"):
        if visual_input_type == "fast-rcnn":
            raise NotImplementedError(
                "fast-rcnn visual inputs are not implemented (the reference's "
                "own path raises NotImplementedError, cocoimages_dataset.py:60-69)")
        if visual_input_type not in VISUAL_INPUT_TYPES:
            raise ValueError(
                f"unknown visual_input_type {visual_input_type!r}; "
                f"expected one of {VISUAL_INPUT_TYPES}")
        self.canvas_hw = canvas_hw
        self.patch_size = patch_size
        self.visual_input_type = visual_input_type
        self.imageid2filename: Dict = {}

    def _load_canvas_u8(self, path: str):
        from PIL import Image

        try:
            if path.lower().endswith((".jpg", ".jpeg")):
                # fully-native path: C++ libjpeg decode + C++ resample
                # (falls through to PIL when unavailable/CMYK)
                out = process_jpeg_file(path, self.canvas_hw, self.patch_size)
                if out is not None:
                    return out
            with Image.open(path) as img:
                return process_image(img, self.canvas_hw, self.patch_size)
        except Exception as e:
            # reference behavior: a broken image becomes a black canvas
            # (utils/image_utils.py:55-59)
            logger.warning("image %s failed to load (%s); black canvas", path, e)
            return (
                np.zeros((*self.canvas_hw, 3), np.uint8),
                (self.canvas_hw[0] // self.patch_size, self.canvas_hw[1] // self.patch_size),
            )

    def load_canvas(self, path: str):
        canvas, patch_hw = self._load_canvas_u8(path)
        if self.visual_input_type == "raw":
            canvas = normalize_canvas_host(canvas)
        return canvas, patch_hw

    def get_image_data(self, image_id):
        return self.load_canvas(self.imageid2filename[image_id])


class MSCOCOImagesDataset(CanvasImageProvider):
    """COCO images (VQA): filename pattern '*_<12-digit-id>.jpg'
    (cocoimages_dataset.py:39-45)."""

    def __init__(self, coco_dir: str, canvas_hw=(384, 640), patch_size: int = 32,
                 visual_input_type: str = "pil-image"):
        super().__init__(canvas_hw, patch_size, visual_input_type)
        self.images_dir = os.path.join(coco_dir, "images")
        for fn in os.listdir(self.images_dir):
            base = fn.split("_")[-1]
            try:
                image_id = int(base.replace(".jpg", ""))
            except ValueError:
                continue
            # index by the REAL filename (COCO files are named
            # 'COCO_<split>2014_<12-digit-id>.jpg') — joining the stripped
            # basename instead pointed every id at a nonexistent path, which
            # the reference-parity black-canvas fallback then silently
            # swallowed (caught by the real-data driver test)
            self.imageid2filename[image_id] = os.path.join(self.images_dir, fn)
        self.imageids = list(self.imageid2filename.keys())
        logger.info("MSCOCO images: %d files", len(self.imageids))


class Flickr30KImagesDataset(CanvasImageProvider):
    """Flickr30K images (SNLI-VE): '<id>.jpg' under flickr30k_images/
    (flickr30kimages_dataset.py:23-45).

    Documented deviation: the reference's Flickr path uses
    ``T.Resize((384,640))`` — a fixed tuple that DISTORTS aspect ratio
    (flickr30kimages_dataset.py:52), unlike its COCO path's
    aspect-preserving ``Resize(384, max_size=640)``. This implementation
    uses the aspect-preserving ViLT resize for both (the reference behavior
    looks like an oversight; HF ViltProcessor re-resizes afterward anyway).
    """

    def __init__(self, flickr_dir: str, canvas_hw=(384, 640), patch_size: int = 32,
                 visual_input_type: str = "pil-image"):
        super().__init__(canvas_hw, patch_size, visual_input_type)
        self.images_dir = os.path.join(flickr_dir, "flickr30k_images")
        for fn in os.listdir(self.images_dir):
            try:
                image_id = int(fn.replace(".jpg", ""))
            except ValueError:
                continue
            self.imageid2filename[image_id] = os.path.join(self.images_dir, fn)
        self.imageids = list(self.imageid2filename.keys())
        logger.info("Flickr30K images: %d files", len(self.imageids))
