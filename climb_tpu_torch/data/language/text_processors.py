"""Language-only task processors (the port's copy of
``climb_tpu/data/language/text_processors.py``; reference
``src/data/language_datasets/text_processors.py``).

Each processor turns a task's files into example dicts {text_a, text_b (a
list), merged_text, label}. Train and dev are split from the original training
set with seed 2022 and a 30% dev share (``split_train_dev``, reference
:71-93); the original dev set serves as the test set, since test labels are not
public.

IMDb and SST-2 are read from local JSON-lines files only
(``{data_dir}/imdb_{train,test}.jsonl``, ``{data_dir}/sst2_{train,validation}.jsonl``,
rows with 'text' or 'sentence' and 'label'). The JAX package falls back to the
HF ``datasets`` hub, which needs the network; the port raises
``FileNotFoundError`` naming the file it expected instead. IMDb's and SST-2's
task configs have no ``data_dir``: give one with ``--task_config_overrides
imdb.data_dir=DIR`` (relative to ``--climb_data_dir``).
"""

import csv
import json
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def split_train_dev(data, seed: int = 2022, dev_ratio: float = 0.3):
    """The reference's split: dev indices drawn by the global
    ``np.random.choice`` after ``np.random.seed(seed)``."""
    data = list(data)
    n = len(data)
    np.random.seed(seed)
    dev_ids = set(np.random.choice(n, int(n * dev_ratio), replace=False))
    train_data, dev_data = [], []
    for i, dt in enumerate(data):
        (dev_data if i in dev_ids else train_data).append(dt)
    return train_data, dev_data, dev_ids


def _read_jsonl(input_file):
    with open(input_file, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


class DataProcessor:
    """Base of the multiple-choice tasks' processors."""

    def __init__(self):
        self.label_map = {label: i for i, label in enumerate(self._set_label_list())}

    def _set_label_list(self):
        raise NotImplementedError

    @classmethod
    def _to_example(cls, example_id, text_a=None, text_b=None, text_c=None, label=None,
                    desc=None):
        return {
            "example_id": example_id,
            "text_a": text_a,
            "text_b": text_b,
            "text_c": text_c,
            "merged_text": [f"{text_a} [SEP] {t_b}" for t_b in (text_b or [])],
            "label": label,
            "description": desc,
        }

    @classmethod
    def _read_csv(cls, input_file):
        with open(input_file, encoding="utf-8") as f:
            return list(csv.reader(f))

    def _train_file_examples(self, data_dir):
        raise NotImplementedError

    def get_train_examples(self, data_dir):
        train, _, self.dev_ids = split_train_dev(self._train_file_examples(data_dir))
        return train

    def get_dev_examples(self, data_dir):
        _, dev, self.dev_ids = split_train_dev(self._train_file_examples(data_dir))
        return dev


class HellaSwagProcessor(DataProcessor):
    def _set_label_list(self):
        return [0, 1, 2, 3]

    def _examples(self, data, has_label=True):
        return [self._to_example(example_id=idx, text_a=dt["ctx"], text_b=dt["endings"],
                                 label=self.label_map[dt["label"]] if has_label else None,
                                 desc="Multiple-Choice; text_a: Ctx; text_b: ending")
                for idx, dt in enumerate(data)]

    def _train_file_examples(self, data_dir):
        return self._examples(_read_jsonl(os.path.join(data_dir, "hellaswag_train.jsonl")))

    def get_test_examples(self, data_dir):
        return self._examples(_read_jsonl(os.path.join(data_dir, "hellaswag_val.jsonl")))


class PIQAProcessor(DataProcessor):
    def _set_label_list(self):
        return ["0", "1"]

    def _examples(self, data, label_path, has_label=True):
        if has_label:
            with open(label_path, encoding="utf-8") as f:
                labels = f.read().splitlines()
        else:
            labels = ["0"] * len(data)
        return [self._to_example(example_id=idx, text_a=dt["goal"],
                                 text_b=[dt["sol1"], dt["sol2"]],
                                 label=self.label_map[lb] if has_label else None,
                                 desc="Multiple-Choice; text_a: Ctx; text_b: Ans")
                for idx, (dt, lb) in enumerate(zip(data, labels))]

    def _train_file_examples(self, data_dir):
        return self._examples(_read_jsonl(os.path.join(data_dir, "train.jsonl")),
                              os.path.join(data_dir, "train-labels.lst"))

    def get_test_examples(self, data_dir):
        return self._examples(_read_jsonl(os.path.join(data_dir, "valid.jsonl")),
                              os.path.join(data_dir, "valid-labels.lst"))


class CommonsenseQAProcessor(DataProcessor):
    def _set_label_list(self):
        return ["A", "B", "C", "D", "E"]

    def _examples(self, data, has_label=True):
        return [self._to_example(example_id=idx, text_a=dt["question"]["stem"],
                                 text_b=[ch["text"] for ch in dt["question"]["choices"]],
                                 label=self.label_map[dt["answerKey"]] if has_label else None,
                                 desc="Multiple-Choice; text_a: Ctx; text_b: Ans")
                for idx, dt in enumerate(data)]

    def _train_file_examples(self, data_dir):
        return self._examples(_read_jsonl(os.path.join(data_dir, "train_rand_split.jsonl")))

    def get_test_examples(self, data_dir):
        return self._examples(_read_jsonl(os.path.join(data_dir, "dev_rand_split.jsonl")))


class COSMOSQAProcessor(DataProcessor):
    """In the reference but used by none of its task configs
    (text_processors.py:226)."""

    def _set_label_list(self):
        return ["0", "1", "2", "3"]

    def _examples(self, data, has_label=True):
        return [self._to_example(example_id=line[0], text_a=line[1],
                                 text_b=[line[3], line[4], line[5], line[6]], text_c=line[2],
                                 label=self.label_map[line[7]] if has_label else None,
                                 desc="Multiple-Choice; text_a: Ctx; text_b: Ans; text_c: Ques")
                for line in data[1:]]

    def _train_file_examples(self, data_dir):
        return self._examples(self._read_csv(os.path.join(data_dir, "train.csv")))

    def get_test_examples(self, data_dir):
        return self._examples(self._read_csv(os.path.join(data_dir, "valid.csv")))


def _read_local_splits(data_dir, task, splits):
    """{split: rows} from ``{data_dir}/{task}_{split}.jsonl``."""
    out = {}
    for split in splits:
        name = f"{task}_{split}.jsonl"
        path = os.path.join(data_dir, name) if data_dir else None
        if path is None or not os.path.isfile(path):
            raise FileNotFoundError(
                f"{task}: expected {path or name + ' in the task data_dir, which is not set'}. "
                f"climb_tpu_torch reads {task} from local {task}_{{{','.join(splits)}}}.jsonl "
                f"files only (the HF hub needs the network); set their directory with "
                f"--task_config_overrides {task}.data_dir=DIR")
        out[split] = _read_jsonl(path)
    return out


class IMDBProcessor:
    """IMDb from ``{data_dir}/imdb_{train,test}.jsonl`` (rows with 'text' and
    'label'); reference text_processors.py:268 reads the HF hub."""

    def __init__(self, data_dir=None):
        data = _read_local_splits(data_dir, "imdb", ("train", "test"))
        self.train_data, self.dev_data, self.dev_ids = split_train_dev(data["train"])
        self.test_data = data["test"]

    def get_train_examples(self, data_dir=None):
        return self.train_data

    def get_dev_examples(self, data_dir=None):
        return self.dev_data

    def get_test_examples(self, data_dir=None):
        return self.test_data


class GLUEProcessor:
    """A GLUE task (SST-2) from ``{data_dir}/{task}_{train,validation}.jsonl``
    (rows with 'sentence' and 'label'); reference text_processors.py:286 reads
    the HF hub."""

    def __init__(self, task="sst2", data_dir=None):
        data = _read_local_splits(data_dir, task, ("train", "validation"))
        self.train_data, self.dev_data, self.dev_ids = split_train_dev(data["train"])
        self.test_data = data["validation"]

    def get_train_examples(self, data_dir=None):
        return self.train_data

    def get_dev_examples(self, data_dir=None):
        return self.dev_data

    def get_test_examples(self, data_dir=None):
        return self.test_data


PROCESSOR_MAP = {
    "piqa": PIQAProcessor,
    "hellaswag": HellaSwagProcessor,
    "commonsenseqa": CommonsenseQAProcessor,
    "cosmosqa": COSMOSQAProcessor,
    "imdb": IMDBProcessor,
    "sst2": GLUEProcessor,
}
