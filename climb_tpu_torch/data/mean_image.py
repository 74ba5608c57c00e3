"""The mean image of the language-only tasks (the port's copy of
``climb_tpu/data/mean_image.py::load_mean_image``).

The reference averages all COCO images offline into ``coco_mean_image.png``
and feeds it as the vacuous visual input of language-only tasks
(train_language.py:67-69). Without the png a neutral gray canvas stands in,
which is as contentless.
"""

import logging
import os

logger = logging.getLogger(__name__)


def load_mean_image(path=None, image_size=None):
    """PIL mean image; a neutral gray canvas when the png is not there."""
    from PIL import Image

    if path and os.path.isfile(path):
        img = Image.open(path).convert("RGB")
    else:
        if path:
            logger.warning("mean image %s not found; using gray canvas", path)
        img = Image.new("RGB", (640, 384), (119, 113, 104))
    if image_size is not None:
        img = img.resize(image_size)
    return img
