"""Synthetic vision-language examples (the port's copy of
``climb_tpu/data/synthetic.py``'s ``SyntheticVLDataset``, with its low-shot
subsets, ``convert_to_low_shot``, ``SubsetDataset`` and the bucketing hints
``canvas_widths()`` and ``text_lengths()``, drawn without making an example).

Deterministic per index and seed, and equal to the JAX package's examples for
the same arguments, so both packages can serve the same synthetic split.
Emits the batch schema of the real VQA/NLVR2/SNLI-VE/VCR pipelines:
  single-image cls: input_ids (L,), text_mask, token_type_ids,
                    pixel_values (H, W, 3) uint8, patch_hw (2,), labels ()
  image-pair cls:   pixel_values (2, H, W, 3), patch_hw (2, 2)
  multi-choice:     input_ids (C, L), text_mask (C, L), token_type_ids (C, L)
  vqa:              target_scores (num_labels,) instead of labels
"""

from typing import Optional, Tuple

import numpy as np


class SyntheticVLDataset:
    def __init__(
        self,
        size: int,
        num_labels: int,
        model_type: str = "classification",
        num_images: int = 1,
        num_choices: Optional[int] = None,
        text_len: int = 40,
        canvas_hw: Tuple[int, int] = (384, 640),
        patch_size: int = 32,
        soft_targets: bool = False,
        seed: int = 0,
        label_noise: float = 0.0,
    ):
        self.size = size
        self.num_labels = num_labels
        self.model_type = model_type
        self.num_images = num_images
        self.num_choices = num_choices
        self.text_len = text_len
        self.canvas_hw = canvas_hw
        self.patch_size = patch_size
        self.soft_targets = soft_targets
        self.seed = seed
        rng = np.random.RandomState(seed)
        n_classes = num_choices if model_type == "multi-choice" else num_labels
        self.labels = rng.randint(0, max(n_classes, 1), size=(size,))
        # with probability label_noise an example's learnable signal encodes a
        # random other class while its target keeps the true label
        self.signal_labels = self.labels.copy()
        if label_noise > 0 and n_classes > 1:
            nrng = np.random.RandomState(seed * 31337 + 7)
            flip = nrng.random_sample(size) < label_noise
            shift = nrng.randint(1, n_classes, size=size)
            self.signal_labels = np.where(flip, (self.labels + shift) % n_classes, self.labels)

    def __len__(self):
        return self.size

    def _patch_hws(self, i: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 7919 + 1000003 + i)
        h, w = self.canvas_hw
        gh, gw = h // self.patch_size, w // self.patch_size
        return rng.randint(
            [1, 1], [gh + 1, gw + 1], size=(max(self.num_images, 1), 2)
        ).astype(np.int32)

    def canvas_widths(self) -> np.ndarray:
        """Needed canvas width (pixels) per example: the aspect-bucketing hint,
        from the patch dims' own stream (no image is made)."""
        return np.array(
            [int(self._patch_hws(i)[:, 1].max()) * self.patch_size for i in range(self.size)],
            np.int64)

    def _text_lens(self, i: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 7919 + 2000003 + i)
        n = self.num_choices if self.model_type == "multi-choice" else 1
        return rng.randint(4, self.text_len, size=(n,))

    def text_lengths(self) -> np.ndarray:
        """Real token count per example: the text-bucketing hint."""
        return np.array([int(self._text_lens(i).max()) for i in range(self.size)], np.int64)

    def _image(self, rng, label):
        h, w = self.canvas_hw
        tile = rng.randint(0, 256, size=(32, 32, 3)).astype(np.uint8)
        img = np.tile(tile, ((h + 31) // 32, (w + 31) // 32, 1))[:h, :w]
        # a label-dependent stamp in the top-left patch makes the data learnable
        img[:16, :16, :] = (label * 37) % 256
        return img

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed * 100003 + i)
        label = int(self.labels[i])
        signal = int(self.signal_labels[i])
        L = self.text_len
        text_lens = iter(self._text_lens(i))

        def text(marker):
            n = int(next(text_lens))
            ids = np.zeros((L,), np.int32)
            ids[0] = 101
            ids[1:n] = rng.randint(1000, 2000, size=(n - 1,))
            ids[1:n - 1:2] = marker
            ids[n - 1] = 102
            mask = np.zeros((L,), np.float32)
            mask[:n] = 1.0
            return ids, mask

        ex = {}
        if self.model_type == "multi-choice":
            nc = self.num_choices
            ids, masks = zip(*[text(999 if c == signal else 998) for c in range(nc)])
            ex["input_ids"] = np.stack(ids)
            ex["text_mask"] = np.stack(masks)
            ex["token_type_ids"] = np.zeros((nc, L), np.int32)
        else:
            ids, mask = text(103 + (signal % 895))
            ex["input_ids"] = ids
            ex["text_mask"] = mask
            ex["token_type_ids"] = np.zeros((L,), np.int32)

        phws = self._patch_hws(i)
        if self.num_images == 2:
            ex["pixel_values"] = np.stack([self._image(rng, signal) for _ in range(2)])
            ex["patch_hw"] = phws
        else:
            ex["pixel_values"] = self._image(rng, signal)
            ex["patch_hw"] = phws[0]

        if self.soft_targets:
            scores = np.zeros((self.num_labels,), np.float32)
            scores[label] = 1.0
            extra = rng.randint(0, self.num_labels)
            scores[extra] = max(scores[extra], 0.3)
            ex["target_scores"] = scores
        else:
            ex["labels"] = np.int32(label)
        return ex

    def convert_to_low_shot(self, percentage: Optional[float] = None,
                            num_shots_per_class: Optional[int] = None, seed: int = 0):
        """The low-shot train subset (reference convert_to_low_shot, e.g.
        vqa_dataset.py:173-187, nlvr2_dataset.py:118-134): a share of the
        examples, or up to ``num_shots_per_class`` of each class, drawn from a
        generator of ``seed``; the kept indices are sorted."""
        rng = np.random.RandomState(seed)
        if percentage is not None:
            n = max(1, int(self.size * percentage))
            keep = rng.choice(self.size, size=n, replace=False)
        else:
            keep = []
            for c in np.unique(self.labels):
                idx = np.where(self.labels == c)[0]
                keep.extend(rng.choice(idx, size=min(num_shots_per_class, len(idx)),
                                       replace=False))
            keep = np.asarray(keep)
        return SubsetDataset(self, np.sort(keep))


class SubsetDataset:
    """The examples of ``base`` at ``indices``, in that order."""

    def __init__(self, base, indices):
        self.base = base
        self.indices = np.asarray(indices)
        self.labels = getattr(base, "labels", None)
        if self.labels is not None:
            self.labels = self.labels[self.indices]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.base[int(self.indices[i])]

    def canvas_widths(self):
        return np.asarray(self.base.canvas_widths())[self.indices]

    def text_lengths(self):
        return np.asarray(self.base.text_lengths())[self.indices]


class SyntheticTextDataset:
    """Language-only synthetic examples (the port's copy of ``climb_tpu``'s
    ``SyntheticTextDataset``; equal arrays for equal arguments). No images: the
    classifier broadcasts a shared mean-image canvas (reference vilt.py:437-441)."""

    def __init__(self, size, num_labels, model_type="classification",
                 num_choices=None, max_len=40, seed=0):
        self.size = size
        self.num_labels = num_labels
        self.model_type = model_type
        self.num_choices = num_choices
        self.max_len = max_len
        self.seed = seed
        rng = np.random.RandomState(seed)
        n_classes = num_choices if model_type == "multi-choice" else num_labels
        self.labels = rng.randint(0, max(n_classes, 1), size=(size,))

    def __len__(self):
        return self.size

    def _text(self, rng, marker):
        L = self.max_len
        n = rng.randint(4, L)
        ids = np.zeros((L,), np.int32)
        ids[0] = 101
        ids[2 : n - 1] = rng.randint(1010, 2000, size=(max(n - 3, 0),))
        # the label-dependent token, repeated so that the pooled representation
        # depends strongly on the label even through randomly initialized layers
        ids[1 : n - 1 : 2] = marker
        ids[n - 1] = 102
        mask = np.zeros((L,), np.float32)
        mask[:n] = 1.0
        return ids, mask

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 999983 + i)
        label = int(self.labels[i])
        if self.model_type == "multi-choice":
            # per-choice markers (correct=999, wrong=998): each choice is scored
            # on its own, so a token shared by every choice would carry no signal
            ids, masks = zip(*[self._text(rng, 999 if c == label else 998)
                               for c in range(self.num_choices)])
            return {
                "input_ids": np.stack(ids),
                "text_mask": np.stack(masks),
                "token_type_ids": np.zeros((self.num_choices, self.max_len), np.int32),
                "labels": np.int32(label),
            }
        ids, mask = self._text(rng, 103 + (label % 895))
        return {
            "input_ids": ids,
            "text_mask": mask,
            "token_type_ids": np.zeros((self.max_len,), np.int32),
            "labels": np.int32(label),
        }


def make_synthetic_vl_dataset(task_key: str, task_cfg: dict, split: str, size: int,
                              text_len: int = 40, canvas_hw=(384, 640), seed: int = 0,
                              label_noise: float = 0.0) -> SyntheticVLDataset:
    """Synthetic stand-in for a real VL task split, shaped by its config."""
    split_seed = {"train": 0, "val": 1, "dev": 1, "test": 2}.get(split, 3)
    return SyntheticVLDataset(
        size=size,
        num_labels=task_cfg["num_labels"],
        model_type=task_cfg["model_type"],
        num_images=task_cfg.get("num_images", 1),
        num_choices=task_cfg.get("num_choices"),
        text_len=text_len,
        canvas_hw=canvas_hw,
        soft_targets=(task_key == "vqa"),
        seed=seed * 17 + split_seed,
        label_noise=label_noise,
    )
