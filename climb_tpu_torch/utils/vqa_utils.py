"""VQA scoring and label-vocabulary utilities (the port's copy of
``climb_tpu/utils/vqa_utils.py``; reference ``src/utils/vqa_utils.py``):

- ``get_score``: the VQA soft score by annotator-agreement count, 0 -> 0.0,
  1 -> 0.3, 2 -> 0.6, 3 -> 0.9, >= 4 -> 1.0;
- ``target_vector``: per-answer scores scattered into a dense ``num_labels``
  target (numpy);
- ``create_vqa_labels``: ans2label.pkl from the answers that occur at least 9
  times across the train and val annotations.
"""

import json
import os
import pickle
from collections import Counter
from typing import Sequence

import numpy as np

from climb_tpu_torch.utils.word_utils import normalize_word

_SCORE_TABLE = (0.0, 0.3, 0.6, 0.9)


def get_score(occurences: int) -> float:
    """VQA soft score for an answer given by `occurences` of 10 annotators."""
    if occurences >= len(_SCORE_TABLE):
        return 1.0
    return _SCORE_TABLE[occurences]


def target_vector(num_labels: int, labels: Sequence[int], scores: Sequence[float]) -> np.ndarray:
    """Dense soft-target vector: target[labels[i]] = scores[i], zeros elsewhere."""
    target = np.zeros((num_labels,), dtype=np.float32)
    if len(labels):
        target[np.asarray(labels, dtype=np.int64)] = np.asarray(scores, dtype=np.float32)
    return target


def create_vqa_labels(vqa_dir: str, min_occurrences: int = 9) -> dict:
    """Build the answer vocabulary (ans2label.pkl) from VQAv2 annotation files."""
    answers = []
    for split in ("train", "val"):
        path = os.path.join(vqa_dir, f"v2_mscoco_{split}2014_annotations.json")
        with open(path) as f:
            annotations = json.load(f)["annotations"]
        answers.extend(normalize_word(a["multiple_choice_answer"]) for a in annotations)

    counter = {k: v for k, v in Counter(answers).items() if v >= min_occurrences}
    ans2label = {k: i for i, k in enumerate(counter.keys())}

    with open(os.path.join(vqa_dir, "ans2label.pkl"), "wb") as f:
        pickle.dump(ans2label, f)
    return ans2label


if __name__ == "__main__":  # the offline tool (reference vqa_utils.py:55-56)
    import sys

    labels = create_vqa_labels(sys.argv[1] if len(sys.argv) > 1 else ".")
    print(f"wrote ans2label.pkl with {len(labels)} answers")
