"""Vision-language task datasets: VQAv2, NLVR2, SNLI-VE, VCR (the port's copy
of ``climb_tpu/data/visionlanguage/datasets.py``).

Parity targets in reference ``src/data/visionlanguage_datasets/``:
- VQAv2 (vqa_dataset.py): questions and annotations joined by question_id,
  answers mapped through ans2label.pkl, soft scores by annotator count,
  pickle cache, percentage low-shot.
- NLVR2 (nlvr2_dataset.py): jsonl with identifier -> img0/img1 paths, split
  rename train/dev/test1, label False/True -> 0/1, per-class low-shot.
- SNLI-VE (snli_ve_dataset.py): jsonl hypotheses, labels
  entailment/contradiction/neutral, Flickr30K images, per-class low-shot.
- VCR (vcr_dataset.py): object references detokenized to gender-neutral
  names or 'the gray <obj>', 4 choice texts 'q [SEP] a' (qa) or
  'q [SEP] a [SEP] r' (qar), pre-drawn bbox images, percentage low-shot.
  (The reference's ``process_list`` reads a stale loop variable for bare-int
  object references, vcr_dataset.py:53-57; this uses the intended index, as
  the JAX package does.)

All text is tokenized ahead of time into fixed (max_text_len) arrays, and
images are decoded and resized in the loader's workers into fixed uint8
canvases; each ``__getitem__`` returns the static batch schema of the train
step. The parse caches (``cached_*`` under each task's data directory) are
the JAX package's files, read and written with the same contents.
"""

import json
import logging
import os
import pickle
import random
import threading
from collections import defaultdict
from typing import Tuple

import numpy as np

from climb_tpu_torch.data.image_backbones import (
    CanvasImageProvider,
    Flickr30KImagesDataset,
    MSCOCOImagesDataset,
)
from climb_tpu_torch.data.cache import load_pickle_cache as _load_cache
from climb_tpu_torch.data.cache import save_pickle_cache as _save_cache
from climb_tpu_torch.data.tokenization import load_tokenizer
from climb_tpu_torch.utils.vqa_utils import get_score, target_vector

logger = logging.getLogger(__name__)

GENDER_NEUTRAL_NAMES = [
    "Casey", "Riley", "Jessie", "Jackie", "Avery", "Jaime", "Peyton", "Kerry",
    "Jody", "Kendall", "Skyler", "Frankie", "Pat", "Quinn", "Morgan", "Finley",
    "Harley", "Robbie", "Sidney", "Tommie", "Ashley", "Carter", "Adrian",
    "Clarke", "Logan", "Mickey", "Nicky", "Parker", "Tyler", "Reese",
    "Charlie", "Austin", "Denver", "Emerson", "Tatum", "Dallas", "Haven",
    "Jordan", "Robin", "Rory", "Bellamy", "Salem", "Sutton", "Gray", "Shae",
    "Kyle", "Alex", "Ryan", "Cameron", "Dakota",
]


def detokenize_vcr_text(mytext, objects) -> str:
    """VCR mixed-token list -> string; object indices become names/colors."""
    parts = []
    for element in mytext:
        if isinstance(element, list):
            for sub in element:
                idx = int(sub)
                if objects[idx] == "person":
                    parts.append(GENDER_NEUTRAL_NAMES[idx % len(GENDER_NEUTRAL_NAMES)])
                else:
                    parts.append("the gray " + str(objects[idx]).strip())
        elif isinstance(element, int):
            idx = int(element)
            if objects[idx] == "person":
                parts.append(GENDER_NEUTRAL_NAMES[idx % len(GENDER_NEUTRAL_NAMES)])
            else:
                parts.append("the gray " + str(objects[idx]).strip())
        else:
            parts.append(str(element))
    return " ".join(parts) + " "


class VLDatasetBase:
    """Shared fixed-shape emission: AOT text encoding + canvas images."""

    # FIFO-bounded memo: full VQA has ~443k distinct questions — an unbounded
    # cache is hundreds of MB on an already memory-starved host, and the
    # native tokenizer makes misses nearly free anyway.
    TOK_CACHE_MAX = 65536

    def __init__(self, tokenizer, max_text_len: int, canvas_hw: Tuple[int, int], patch_size: int = 32):
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.canvas_hw = canvas_hw
        self.patch_size = patch_size
        self._tok_cache = {}
        # the loader's thread workers share the memo: evicting the oldest
        # entry is check-then-act (two threads could pop one key, or iterate
        # while a third inserts)
        self._tok_lock = threading.Lock()

    def encode_text(self, text: str):
        cached = self._tok_cache.get(text)
        if cached is None:
            cached = self.tokenizer.encode(text, self.max_text_len)
            with self._tok_lock:
                if len(self._tok_cache) >= self.TOK_CACHE_MAX:
                    self._tok_cache.pop(next(iter(self._tok_cache)))
                self._tok_cache[text] = cached
        return cached

    def _text_fields(self, text: str):
        ids, mask, types = self.encode_text(text)
        return {"input_ids": ids, "text_mask": mask, "token_type_ids": types}

    # -- aspect-bucketing support --------------------------------------------
    def _image_paths(self, ex) -> list:
        """Image file path(s) of one self.data record (per-dataset)."""
        raise NotImplementedError

    def canvas_widths(self) -> np.ndarray:
        """Per-example needed canvas width (pixels) — the DataLoader's
        aspect-bucketing hint (header-only dims reads; path->dims memoized
        on disk next to the dataset's annotation cache)."""
        from climb_tpu_torch.data.image_pipeline import predict_canvas_widths

        memo = getattr(self, "_dims_memo", None)
        if memo is None:
            memo = self._dims_memo = {}
        return predict_canvas_widths(
            [self._image_paths(ex) for ex in self.data],
            self.canvas_hw,
            cache_path=getattr(self, "_dims_cache_path", None),
            memo=memo,
        )

    # -- text-length-bucketing support ---------------------------------------
    def _example_texts(self, ex) -> list:
        """Text string(s) of one self.data record (per-dataset)."""
        raise NotImplementedError

    def text_lengths(self) -> np.ndarray:
        """Per-example real token count (max over an example's texts) — the
        DataLoader's text-length-bucketing hint. Token counts come from the
        actual tokenizer (exact, so bucket misses only happen on the safety
        path); text->len is memoized on disk next to the annotation cache."""
        cache_path = getattr(self, "_tlen_cache_path", None)
        memo = getattr(self, "_tlen_memo", None)
        if memo is None:
            memo = _load_cache(cache_path) if cache_path else None
            memo = self._tlen_memo = memo if isinstance(memo, dict) else {}
        dirty = False
        lens = np.empty((len(self.data),), np.int64)
        for i, ex in enumerate(self.data):
            n = 0
            for t in self._example_texts(ex):
                ln = memo.get(t)
                if ln is None:
                    _, mask, _ = self.encode_text(t)
                    memo[t] = ln = int(np.sum(mask))
                    dirty = True
                n = max(n, ln)
            lens[i] = n
        if dirty and cache_path:
            try:
                _save_cache(cache_path, memo)
            except OSError:
                pass
        return lens


class VQADataset(VLDatasetBase):
    def __init__(self, data_dir: str, images_dataset: MSCOCOImagesDataset, split: str,
                 tokenizer=None, max_text_len: int = 40, canvas_hw=(384, 640),
                 num_labels=None, **kw):
        super().__init__(tokenizer or load_tokenizer(), max_text_len, canvas_hw)
        self.data_dir = data_dir
        self.images_dataset = images_dataset
        self.split = split

        with open(os.path.join(data_dir, "ans2label.pkl"), "rb") as f:
            self.ans2label = pickle.load(f)
        self.label2ans = {v: k for k, v in self.ans2label.items()}
        # Target-vector width follows the TASK CONFIG, so the emitted
        # targets always match the model head. This is the port's (and the
        # JAX package's) deviation: the reference sets num_labels =
        # len(label2ans) (its vqa_dataset.py:69). With the full 3,129-answer
        # ans2label the two coincide; with a smaller map (mini fixtures)
        # they differ.
        self.num_labels = num_labels or len(self.ans2label)

        cache = os.path.join(data_dir, "cached_vqa_data", f"vqa_{split}.pkl")
        self.data = _load_cache(cache)
        if self.data is None:
            with open(os.path.join(data_dir, f"v2_OpenEnded_mscoco_{split}2014_questions.json")) as f:
                questions = json.load(f)["questions"]
            qid2qdata = {q["question_id"]: q for q in questions}
            with open(os.path.join(data_dir, f"v2_mscoco_{split}2014_annotations.json")) as f:
                annotations = json.load(f)["annotations"]
            self.data = []
            for anno in annotations:
                qid = anno["question_id"]
                qdata = qid2qdata[qid]
                assert qdata["image_id"] == anno["image_id"]
                answer_count = defaultdict(int)
                for a in anno["answers"]:
                    answer_count[a["answer"]] += 1
                labels, scores = [], []
                for answer, cnt in answer_count.items():
                    if answer not in self.ans2label:
                        continue
                    labels.append(self.ans2label[answer])
                    scores.append(get_score(cnt))
                self.data.append({
                    "question_id": qid,
                    "image_id": anno["image_id"],
                    "question": qdata["question"],
                    "correct_answer": anno["multiple_choice_answer"],
                    "labels": labels,
                    "scores": scores,
                })
            _save_cache(cache, self.data)
        self.n_examples = len(self.data)
        self._dims_cache_path = os.path.join(data_dir, "cached_vqa_data", "image_dims.pkl")
        self._tlen_cache_path = os.path.join(data_dir, "cached_vqa_data", "text_lens.pkl")
        logger.info("Loaded VQAv2 %s: %d examples", split, self.n_examples)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        ex = self.data[index]
        pixel_values, patch_hw = self.images_dataset.get_image_data(ex["image_id"])
        out = self._text_fields(ex["question"])
        out["pixel_values"] = pixel_values
        out["patch_hw"] = np.asarray(patch_hw, np.int32)
        out["target_scores"] = target_vector(self.num_labels, ex["labels"], ex["scores"])
        return out

    def _image_paths(self, ex):
        return [self.images_dataset.imageid2filename[ex["image_id"]]]

    def _example_texts(self, ex):
        return [ex["question"]]

    def convert_to_low_shot(self, percentage: float = None, num_shots_per_class=None, seed=None):
        """seed=None reproduces the reference (global python RNG,
        vqa_dataset.py:173-187); an explicit seed gives a self-contained
        draw independent of global RNG state."""
        assert self.split == "train"
        n = int(percentage * self.n_examples)
        rng = random.Random(seed) if seed is not None else random
        self.data = rng.sample(self.data, n)
        self.n_examples = len(self.data)
        logger.info("VQA low-shot: %d examples (%.1f%%)", n, percentage * 100)
        return self


class NLVR2Dataset(VLDatasetBase):
    SPLIT_RENAME = {"train": "train", "val": "dev", "test": "test1"}

    def __init__(self, data_dir: str, split: str, tokenizer=None,
                 max_text_len: int = 40, canvas_hw=(384, 640),
                 visual_input_type: str = "pil-image"):
        super().__init__(tokenizer or load_tokenizer(), max_text_len, canvas_hw)
        self.data_dir = data_dir
        self.split = split
        self.num_labels = 2
        _split = self.SPLIT_RENAME[split]
        self.image_dir = os.path.join(data_dir, "images", _split)
        self._provider = CanvasImageProvider(
            canvas_hw, visual_input_type=visual_input_type)

        cache = os.path.join(data_dir, "cached_nlvr2_data", f"{_split}.pkl")
        self.data = _load_cache(cache)
        if self.data is None:
            self.data = []
            with open(os.path.join(data_dir, "data", f"{_split}.json")) as f:
                for line in f:
                    if not line.strip():
                        continue
                    anno = json.loads(line)
                    stem = "-".join(anno["identifier"].split("-")[:-1])
                    self.data.append({
                        "id": anno["identifier"],
                        "image_id_0": os.path.join(self.image_dir, stem + "-img0.png"),
                        "image_id_1": os.path.join(self.image_dir, stem + "-img1.png"),
                        "sentence": str(anno["sentence"]),
                        "labels": 0 if str(anno["label"]) == "False" else 1,
                    })
            _save_cache(cache, self.data)
        self.n_examples = len(self.data)
        self._dims_cache_path = os.path.join(data_dir, "cached_nlvr2_data", "image_dims.pkl")
        self._tlen_cache_path = os.path.join(data_dir, "cached_nlvr2_data", "text_lens.pkl")
        logger.info("Loaded NLVR2 %s: %d examples", split, self.n_examples)

    def __len__(self):
        return self.n_examples

    def __getitem__(self, index: int) -> dict:
        ex = self.data[index]
        img0, phw0 = self._provider.load_canvas(ex["image_id_0"])
        img1, phw1 = self._provider.load_canvas(ex["image_id_1"])
        out = self._text_fields(ex["sentence"])
        out["pixel_values"] = np.stack([img0, img1])
        out["patch_hw"] = np.asarray([phw0, phw1], np.int32)
        out["labels"] = np.int32(ex["labels"])
        return out

    def _image_paths(self, ex):
        return [ex["image_id_0"], ex["image_id_1"]]

    def _example_texts(self, ex):
        return [ex["sentence"]]

    def convert_to_low_shot(self, percentage=None, num_shots_per_class: int = None, seed=None):
        """seed=None reproduces the reference (global python RNG,
        nlvr2_dataset.py:118-134); an explicit seed is self-contained."""
        assert self.split == "train"
        rng = random.Random(seed) if seed is not None else random
        new_data = []
        for i in range(self.num_labels):
            i_examples = [d for d in self.data if d["labels"] == i]
            new_data.extend(rng.sample(i_examples, min(num_shots_per_class, len(i_examples))))
        self.data = new_data
        self.n_examples = len(self.data)
        logger.info("NLVR2 low-shot: %d examples", self.n_examples)
        return self


class SnliVEDataset(VLDatasetBase):
    CATEGORIES = ["entailment", "contradiction", "neutral"]

    def __init__(self, data_dir: str, images_dataset: Flickr30KImagesDataset, split: str,
                 tokenizer=None, max_text_len: int = 40, canvas_hw=(384, 640), **kw):
        super().__init__(tokenizer or load_tokenizer(), max_text_len, canvas_hw)
        self.data_dir = data_dir
        self.images_dataset = images_dataset
        self.split = split
        self.cat2label = {c: i for i, c in enumerate(self.CATEGORIES)}
        self.num_labels = len(self.CATEGORIES)

        cache = os.path.join(data_dir, "cached_ve_data", f"snli-ve_{split}.pkl")
        self.data = _load_cache(cache)
        if self.data is None:
            self.data = []
            with open(os.path.join(data_dir, f"snli_ve_{split}.jsonl")) as f:
                for line in f:
                    if not line.strip():
                        continue
                    ex = json.loads(line)
                    self.data.append({
                        "image_id": int(ex["Flickr30K_ID"]),
                        "hypothesis": str(ex["sentence2"]),
                        "label": self.cat2label[ex["gold_label"]],
                    })
            _save_cache(cache, self.data)
        self.n_examples = len(self.data)
        self._dims_cache_path = os.path.join(data_dir, "cached_ve_data", "image_dims.pkl")
        self._tlen_cache_path = os.path.join(data_dir, "cached_ve_data", "text_lens.pkl")
        logger.info("Loaded SNLI-VE %s: %d examples", split, self.n_examples)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        ex = self.data[index]
        pixel_values, patch_hw = self.images_dataset.get_image_data(ex["image_id"])
        out = self._text_fields(ex["hypothesis"])
        out["pixel_values"] = pixel_values
        out["patch_hw"] = np.asarray(patch_hw, np.int32)
        out["labels"] = np.int32(ex["label"])
        return out

    def _image_paths(self, ex):
        return [self.images_dataset.imageid2filename[ex["image_id"]]]

    def _example_texts(self, ex):
        return [ex["hypothesis"]]

    def convert_to_low_shot(self, percentage=None, num_shots_per_class: int = None, seed=None):
        """seed=None reproduces the reference (global python RNG,
        snli_ve_dataset.py:127-142); an explicit seed is self-contained."""
        assert self.split == "train"
        rng = random.Random(seed) if seed is not None else random
        new_data = []
        for i in range(self.num_labels):
            i_examples = [d for d in self.data if d["label"] == i]
            new_data.extend(rng.sample(i_examples, min(num_shots_per_class, len(i_examples))))
        self.data = new_data
        self.n_examples = len(self.data)
        logger.info("SNLI-VE low-shot: %d examples", self.n_examples)
        return self


class VCRDataset(VLDatasetBase):
    def __init__(self, data_dir: str, split: str, task_type: str = "qa", tokenizer=None,
                 max_text_len: int = 40, canvas_hw=(384, 640),
                 visual_input_type: str = "pil-image"):
        super().__init__(tokenizer or load_tokenizer(), max_text_len, canvas_hw)
        self.data_dir = data_dir
        self.split = split
        self.task_type = task_type
        self.num_choices = 4
        self._provider = CanvasImageProvider(
            canvas_hw, visual_input_type=visual_input_type)

        cache = os.path.join(data_dir, "cached_vcr_data", f"vcr_{task_type}_{split}.pkl")
        self.data = _load_cache(cache)
        if self.data is None:
            self.data = []
            with open(os.path.join(data_dir, "annotation", f"{split}.jsonl")) as f:
                for line in f:
                    if not line.strip():
                        continue
                    anno = json.loads(line)
                    objects = anno["objects"]
                    image_path = os.path.join(
                        data_dir, "drawn_images", "bbox", split, task_type,
                        f"{anno['annot_id']}.jpg",
                    )
                    question = detokenize_vcr_text(anno["question"], objects)
                    texts = []
                    if task_type == "qa":
                        for answer in anno["answer_choices"]:
                            texts.append(question + " [SEP] " + detokenize_vcr_text(answer, objects))
                        label = int(anno["answer_label"])
                    else:
                        answer = detokenize_vcr_text(
                            anno["answer_choices"][int(anno["answer_label"])], objects
                        )
                        for rationale in anno["rationale_choices"]:
                            texts.append(
                                question + " [SEP] " + answer + " [SEP] "
                                + detokenize_vcr_text(rationale, objects)
                            )
                        label = int(anno["rationale_label"])
                    self.data.append({"image_path": image_path, "texts": texts, "label": label})
            _save_cache(cache, self.data)
        self.n_examples = len(self.data)
        self._dims_cache_path = os.path.join(data_dir, "cached_vcr_data", "image_dims.pkl")
        self._tlen_cache_path = os.path.join(data_dir, "cached_vcr_data", f"text_lens_{task_type}.pkl")
        logger.info("Loaded VCR(%s) %s: %d examples", task_type, split, self.n_examples)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        ex = self.data[index]
        pixel_values, patch_hw = self._provider.load_canvas(ex["image_path"])
        encs = [self.encode_text(t) for t in ex["texts"]]
        ids, mask, types = (np.stack(x) for x in zip(*encs))
        return {
            "input_ids": ids,
            "text_mask": mask,
            "token_type_ids": types,
            "pixel_values": pixel_values,
            "patch_hw": np.asarray(patch_hw, np.int32),
            "labels": np.int32(ex["label"]),
        }

    def _image_paths(self, ex):
        return [ex["image_path"]]

    def _example_texts(self, ex):
        return list(ex["texts"])

    def convert_to_low_shot(self, percentage: float = None, num_shots_per_class=None, seed=None):
        """seed=None reproduces the reference (global python RNG,
        vcr_dataset.py:173-187); an explicit seed is self-contained."""
        assert self.split == "train"
        n = int(percentage * self.n_examples)
        rng = random.Random(seed) if seed is not None else random
        self.data = rng.sample(self.data, n)
        self.n_examples = len(self.data)
        logger.info("VCR low-shot: %d examples", self.n_examples)
        return self


def build_vl_datasets(args, task_key: str, task_cfg: dict):
    """(train, eval) datasets for an upstream VL task from climb_data_dir
    (reference per-trainer dataloader builders, SURVEY.md section 2.4)."""
    root = args.climb_data_dir
    canvas = (getattr(args, "image_height", 384), getattr(args, "image_width", 640))
    max_len = getattr(args, "max_text_len", 40)
    tok = load_tokenizer(getattr(args, "tokenizer", "bert-base-uncased"),
                         getattr(args, "vocab_path", None))
    data_dir = os.path.join(root, task_cfg["data_dir"])
    vit = getattr(args, "visual_input_type", "pil-image")

    if task_key == "vqa":
        images = MSCOCOImagesDataset(os.path.join(root, "ms-coco/"), canvas,
                                     visual_input_type=vit)
        return (
            VQADataset(data_dir, images, "train", tok, max_len, canvas,
                       num_labels=task_cfg["num_labels"]),
            VQADataset(data_dir, images, "val", tok, max_len, canvas,
                       num_labels=task_cfg["num_labels"]),
        )
    if task_key == "nlvr2":
        return (
            NLVR2Dataset(data_dir, "train", tok, max_len, canvas, visual_input_type=vit),
            NLVR2Dataset(data_dir, "val", tok, max_len, canvas, visual_input_type=vit),
        )
    if task_key == "snli-ve":
        images = Flickr30KImagesDataset(os.path.join(root, "flickr30k/"), canvas,
                                        visual_input_type=vit)
        return (
            SnliVEDataset(data_dir, images, "train", tok, max_len, canvas),
            SnliVEDataset(data_dir, images, "dev", tok, max_len, canvas),
        )
    if task_key == "vcr":
        task_type = task_cfg.get("task_type", "qa")
        return (
            VCRDataset(data_dir, "train", task_type, tok, max_len, canvas,
                       visual_input_type=vit),
            VCRDataset(data_dir, "dev", task_type, tok, max_len, canvas,
                       visual_input_type=vit),
        )
    raise KeyError(task_key)
