"""Vision-only task datasets of Phase II (the port's copy of
``climb_tpu/data/vision/datasets.py``; reference ``src/data/vision_datasets/``).

- ImageNet (imagenet_dataset.py): a directory of JPEGs per class under
  ``train/``; val is 50 a class carved from train (shuffle seed 2022); test is
  the original val through ``LOC_val_solution.csv``; ``n_shot`` a class drawn
  with ``subsample_seed``.
- Places365 (places365_dataset.py): the same pattern, 365 classes, ``.jpg``.
- iNat2019 (inat2019_dataset.py): json annotations; a class with at most
  ``n_shot`` examples is kept whole; val is min(10%, 50) a class.
- COCO-cls (coco_cls_dataset.py): 80-way multi-label from the instance
  detections (``instances_*2017.json`` read directly); a 10% val split; the
  train split subsampled by a share (``n_shot`` is a fraction here); 80-dim
  multi-hot labels; the parse is cached beside the annotations
  (``cached_{train,val}.pkl``, shared with the JAX package).

Every example has the fixed schema of the VL datasets, with the dummy text
"This is an image." (reference batch_collate, e.g. imagenet_dataset.py:141-146)
tokenized once. The splits and draws use Python's global ``random`` in the
JAX package's order, so both packages keep the same files.
"""

import csv
import glob
import json
import logging
import os
import random
from collections import defaultdict
from typing import Optional

import numpy as np

from climb_tpu_torch.data.cache import load_pickle_cache, save_pickle_cache
from climb_tpu_torch.data.image_backbones import CanvasImageProvider
from climb_tpu_torch.data.image_pipeline import predict_canvas_widths
from climb_tpu_torch.data.tokenization import load_tokenizer

logger = logging.getLogger(__name__)

DUMMY_TEXT = "This is an image."


class VisionDatasetBase(CanvasImageProvider):
    def __init__(self, tokenizer=None, max_text_len: int = 40, canvas_hw=(384, 640)):
        super().__init__(canvas_hw)
        tok = tokenizer or load_tokenizer()
        ids, mask, types = tok.encode(DUMMY_TEXT, max_text_len)
        self._text = {"input_ids": ids, "text_mask": mask, "token_type_ids": types}
        self.dataset = []  # [filename, label or class ids] per example

    def __len__(self):
        return len(self.dataset)

    def _example(self, filename, label):
        pixel_values, patch_hw = self.load_canvas(filename)
        return {
            **self._text,
            "pixel_values": pixel_values,
            "patch_hw": np.asarray(patch_hw, np.int32),
            "labels": label,
        }

    def __getitem__(self, i):
        filename, label = self.dataset[i]
        return self._example(filename, np.int32(label))

    def canvas_widths(self):
        """Per-example canvas width the image needs, from its header alone
        (the aspect-bucketing hint)."""
        memo = getattr(self, "_dims_memo", None)
        if memo is None:
            memo = self._dims_memo = {}
        return predict_canvas_widths([[fn] for fn, _ in self.dataset], self.canvas_hw, memo=memo)


def _class_split_subsample(per_class, mode, n_shot, subsample_seed, val_num_per_class=50,
                           keep_small_classes=False, val_ratio_cap: Optional[float] = None):
    """The reference's get_train_val_split (imagenet_dataset.py:55-83,
    inat2019_dataset.py:51-85): per class, a seed-2022 shuffle, val carved from
    the tail, then the train part shuffled with ``subsample_seed`` and its
    first ``n_shot`` kept.

    Deviation kept from the JAX package: with ``subsample_seed`` None the
    reference seeds the train shuffle from system entropy; here it falls back
    to 2022, so that the order is the same in every construction. The
    reference's drivers always pass a seed."""
    train_out, val_out = [], []
    train_seed = subsample_seed if subsample_seed is not None else 2022
    for cls_data in per_class:
        cls_data = list(cls_data)
        if keep_small_classes and len(cls_data) <= (n_shot or 0):
            train_out.extend(cls_data)
            continue
        n_val = val_num_per_class
        if val_ratio_cap is not None:
            n_val = min(int(len(cls_data) * val_ratio_cap), val_num_per_class)
        n_train = len(cls_data) - n_val
        random.seed(2022)
        random.shuffle(cls_data)
        train_cls = cls_data[:n_train]
        val_out.extend(cls_data[n_train:])
        if mode == "train":
            random.seed(train_seed)
            random.shuffle(train_cls)
            train_out.extend(train_cls[:n_shot] if n_shot else train_cls)
    return train_out if mode == "train" else val_out


def _per_class_files(image_dir, classes, pattern):
    return [[[fn, label] for fn in sorted(glob.glob(os.path.join(image_dir, name, pattern)))]
            for label, name in enumerate(classes)]


class ImageNetDataset(VisionDatasetBase):
    NUM_CLASSES = 1000

    def __init__(self, data_dir, mode, n_shot=None, subsample_seed=None, tokenizer=None,
                 max_text_len=40, canvas_hw=(384, 640)):
        super().__init__(tokenizer, max_text_len, canvas_hw)
        all_classes = sorted(os.listdir(os.path.join(data_dir, "train")))
        if mode == "test":
            dir2lb = {name: i for i, name in enumerate(all_classes)}
            with open(os.path.join(data_dir, "LOC_val_solution.csv")) as f:
                for line in csv.DictReader(f):
                    fn = os.path.join(data_dir, "val", line["ImageId"] + ".JPEG")
                    self.dataset.append([fn, dir2lb[line["PredictionString"].split()[0]]])
        else:
            per_class = _per_class_files(os.path.join(data_dir, "train"), all_classes, "*.JPEG")
            self.dataset = _class_split_subsample(per_class, mode, n_shot, subsample_seed)
        logger.info("ImageNet %s: %d images", mode, len(self.dataset))


class Places365Dataset(VisionDatasetBase):
    NUM_CLASSES = 365

    def __init__(self, data_dir, mode, n_shot=None, subsample_seed=None, tokenizer=None,
                 max_text_len=40, canvas_hw=(384, 640)):
        super().__init__(tokenizer, max_text_len, canvas_hw)
        image_dir = os.path.join(data_dir, "val" if mode == "test" else "train")
        all_classes = sorted(os.listdir(os.path.join(data_dir, "train")))
        per_class = _per_class_files(image_dir, all_classes, "*.jpg")
        if mode == "test":
            self.dataset = [ex for cls_data in per_class for ex in cls_data]
        else:
            self.dataset = _class_split_subsample(per_class, mode, n_shot, subsample_seed)
        logger.info("Places365 %s: %d images", mode, len(self.dataset))


class Inat2019Dataset(VisionDatasetBase):
    NUM_CLASSES = 1010

    def __init__(self, data_dir, mode, n_shot=None, subsample_seed=None, tokenizer=None,
                 max_text_len=40, canvas_hw=(384, 640)):
        super().__init__(tokenizer, max_text_len, canvas_hw)
        remap = {"train": "train", "val": "train", "test": "val"}
        with open(os.path.join(data_dir, f"{remap[mode]}2019.json")) as f:
            ann = json.load(f)
        fns = [a["file_name"] for a in ann["images"]]
        labels = [a["category_id"] for a in ann["annotations"]]
        if len(fns) != len(labels):
            raise ValueError(f"iNat2019 {mode}: {len(fns)} images but {len(labels)} labels")
        if mode == "test":
            self.dataset = [[os.path.join(data_dir, fn), lb] for fn, lb in zip(fns, labels)]
        else:
            per_class = [[] for _ in range(max(labels) + 1)]
            for fn, lb in zip(fns, labels):
                per_class[lb].append([os.path.join(data_dir, fn), lb])
            self.dataset = _class_split_subsample(per_class, mode, n_shot, subsample_seed,
                                                  keep_small_classes=True, val_ratio_cap=0.1)
        logger.info("iNat2019 %s: %d images", mode, len(self.dataset))


class CocoClsDataset(VisionDatasetBase):
    """Multi-label 80-way object classification from the COCO detections;
    ``n_shot`` is the share of the whole train file kept for training
    (reference train_vision.py:119-122)."""

    NUM_CLASSES = 80

    def __init__(self, data_dir, mode, n_shot=None, subsample_seed=None, tokenizer=None,
                 max_text_len=40, canvas_hw=(384, 640)):
        super().__init__(tokenizer, max_text_len, canvas_hw)
        fn_mode = {"train": "train", "val": "train", "test": "val"}[mode]
        cached = os.path.join(data_dir, f"cached_{fn_mode}.pkl")
        dataset = load_pickle_cache(cached)
        if dataset is None:
            annot_file = os.path.join(data_dir, "detections", "annotations",
                                      f"instances_{fn_mode}2017.json")
            with open(annot_file) as f:
                ann = json.load(f)
            cat_ids = sorted({a["category_id"] for a in ann["annotations"]})
            cat2cls = {c: i for i, c in enumerate(cat_ids)}
            img2classes = defaultdict(set)
            for a in ann["annotations"]:
                img2classes[a["image_id"]].add(cat2cls[a["category_id"]])
            images_dir = os.path.join(data_dir, "images")
            dataset = [[os.path.join(images_dir, "{:012d}.jpg".format(i)),
                        sorted(img2classes[i])] for i in sorted(img2classes)]
            save_pickle_cache(cached, dataset)

        if mode == "test":
            self.dataset = dataset
        else:
            # a 10% val split after a seed-2022 shuffle; the rest shuffled with
            # subsample_seed (None too: system entropy, as in the reference)
            # and cut to the share (coco_cls_dataset.py:55-81)
            random.seed(2022)
            random.shuffle(dataset)
            n_val = int(len(dataset) * 0.1)
            if mode == "val":
                self.dataset = dataset[:n_val]
            else:
                train = dataset[n_val:]
                random.seed(subsample_seed)
                random.shuffle(train)
                if n_shot:
                    n_train = int(n_shot * len(dataset))
                    if n_train >= len(train):
                        raise ValueError(f"COCO-cls: a share of {n_shot} keeps {n_train} of "
                                         f"{len(train)} train images; it must keep fewer")
                    train = train[:n_train]
                self.dataset = train
        logger.info("COCO-cls %s: %d images", mode, len(self.dataset))

    def __getitem__(self, i):
        filename, class_ids = self.dataset[i]
        multi_hot = np.zeros((self.NUM_CLASSES,), np.float32)
        multi_hot[np.asarray(class_ids, np.int64)] = 1.0
        return self._example(filename, multi_hot)


VISION_DATASETS = {
    "imagenet": ImageNetDataset,
    "places365": Places365Dataset,
    "inat2019": Inat2019Dataset,
    "coco-cls": CocoClsDataset,
}


def build_vision_dataset(task_key, data_dir, split, n_shot=None, subsample_seed=None,
                         tokenizer=None, max_text_len=40, canvas_hw=(384, 640)):
    return VISION_DATASETS[task_key](data_dir, split, n_shot, subsample_seed, tokenizer,
                                     max_text_len, canvas_hw)
