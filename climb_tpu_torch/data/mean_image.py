"""Mean-image synthesis and loading (the port's copy of
``climb_tpu/data/mean_image.py``).

The reference averages all COCO images offline into ``coco_mean_image.png``
(``src/data/image_datasets/get_avg_images.py``) and feeds it as the vacuous
visual input of language-only tasks (train_language.py:67-69).
``compute_mean_image`` is that tool (``python -m
climb_tpu_torch.data.mean_image IMAGES_DIR [OUT_PNG] [--limit N]``);
``load_mean_image`` loads the png, or a neutral gray canvas, which is as
contentless, when the png is not there.
"""

import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def compute_mean_image(images_dir: str, out_path: str, size=(640, 384), limit=None):
    """Average all images in a directory into one RGB png (reference
    get_avg_images.py:73-96 semantics: resize+pad each to the canvas, mean)."""
    from PIL import Image

    from climb_tpu_torch.utils.image_utils import resize_image

    files = sorted(os.listdir(images_dir))
    if limit:
        files = files[:limit]
    acc = np.zeros((min(size), max(size), 3), np.float64)
    n = 0
    for fn in files:
        try:
            with Image.open(os.path.join(images_dir, fn)) as img:
                acc += resize_image(img, size)
                n += 1
        except (OSError, Image.DecompressionBombError):  # skipped, as the reference does
            continue
    mean = (acc / max(n, 1)).astype(np.uint8)
    Image.fromarray(mean).save(out_path)
    logger.info("Mean image over %d files -> %s", n, out_path)
    return mean


def main(argv=None):
    """CLI: offline mean-image synthesis (reference get_avg_images.py)."""
    import argparse

    parser = argparse.ArgumentParser(description=compute_mean_image.__doc__)
    parser.add_argument("images_dir")
    parser.add_argument("out_path", nargs="?", default="coco_mean_image.png")
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    compute_mean_image(args.images_dir, args.out_path, limit=args.limit)


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


if __name__ == "__main__":
    main()
