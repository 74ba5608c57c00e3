"""The language-only dataset with its n-shot draw (the port's copy of
``climb_tpu/data/language/text_dataset.py``; reference
``src/data/language_datasets/text_dataset.py``).

The train split keeps ``n_shot`` examples of a multiple-choice task, drawn by
``np.random.choice`` after ``np.random.seed(seed)``, or ``n_shot`` of each
class of a classification task (text_dataset.py:33-47): the global numpy
generator, drawn in the reference's order. Examples are encoded when read:
classification gives one text's arrays; multiple choice gives the (choices, L)
encodings of the pairs (text_a, text_b[i]) (reference
``convert_mc_batch_to_vilt_input_dict``, vilt.py:559-567).
"""

import logging

import numpy as np

from climb_tpu_torch.data.language.text_processors import PROCESSOR_MAP
from climb_tpu_torch.data.tokenization import load_tokenizer

logger = logging.getLogger(__name__)

MC_TASKS = {"commonsenseqa", "hellaswag", "piqa", "cosmosqa"}


class LanguageDataset:
    def __init__(self, processor, data_dir, split, task_name, n_shot=None, seed=None,
                 tokenizer=None, max_len: int = 40):
        self.task_name = task_name
        self.tokenizer = tokenizer or load_tokenizer()
        self.max_len = max_len
        self.is_mc = task_name in MC_TASKS

        if split == "train":
            data = processor.get_train_examples(data_dir)
            np.random.seed(seed)
            if self.is_mc:
                self.sel_ids = set(np.random.choice(len(data), n_shot, replace=False))
            else:
                labels = np.array([dt["label"] for dt in data])
                sel = set(np.random.choice(np.where(labels == 1)[0], n_shot, replace=False))
                sel |= set(np.random.choice(np.where(labels == 0)[0], n_shot, replace=False))
                self.sel_ids = sel
            self.data = [dt for i, dt in enumerate(data) if i in self.sel_ids]
        elif split == "val":
            self.data = processor.get_dev_examples(data_dir)
        else:
            self.data = processor.get_test_examples(data_dir)
        self.n_examples = len(self.data)
        logger.info("%s %s: %d examples", task_name, split, self.n_examples)

    def __len__(self):
        return self.n_examples

    def _text_of(self, example):
        if self.task_name == "sst2":
            return example["sentence"]
        if self.task_name == "imdb":
            return example["text"]
        return example["text_a"]

    def __getitem__(self, index):
        ex = self.data[index]
        if self.is_mc:
            encs = [self.tokenizer.encode(ex["text_a"], self.max_len, text_pair=tb)
                    for tb in ex["text_b"]]
            ids, mask, types = (np.stack(x) for x in zip(*encs))
        else:
            ids, mask, types = self.tokenizer.encode(self._text_of(ex), self.max_len)
        return {"input_ids": ids, "text_mask": mask, "token_type_ids": types,
                "labels": np.int32(ex["label"])}


def build_language_dataset(task_name, data_dir, split, max_len, n_shot=None, seed=None,
                           tokenizer=None):
    task_name = task_name.lower()
    proc_cls = PROCESSOR_MAP[task_name]
    processor = proc_cls(data_dir=data_dir) if task_name in ("imdb", "sst2") else proc_cls()
    return LanguageDataset(processor, data_dir, split, task_name, n_shot, seed, tokenizer,
                           max_len)
