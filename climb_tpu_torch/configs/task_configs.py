"""Task registry: the four Phase I vision-language tasks and the Phase II
language-only tasks.

The port's own copy of those entries of ``climb_tpu/configs/task_configs.py``
(values identical, reference ``src/configs/task_configs.py:16-170``).
"""

SUPPORTED_VL_TASKS = ["vqa", "nlvr2", "snli-ve", "vcr"]

vqa_config = {
    "task_name": "VQAv2",
    "data_dir": "vqav2/",
    "images_source": "ms-coco",
    "splits": ["train", "val"],
    "num_labels": 3129,
    "num_images": 1,
    "model_type": "classification",
    "num_epochs": 10,
    "lr": 1e-4,
    "weight_decay": 1e-2,
    "adam_epsilon": 1e-8,
    "warmup_ratio": 0.1,
    "trainer": "vqa",
    "random_baseline_score": 0.0,
}

nlvr_config = {
    "task_name": "NLVRv2",
    "data_dir": "nlvr2/",
    "splits": ["train", "val"],
    "num_labels": 2,
    "num_images": 2,
    "model_type": "classification",
    "num_epochs": 10,
    "lr": 1e-4,
    "weight_decay": 1e-2,
    "adam_epsilon": 1e-8,
    "warmup_ratio": 0.1,
    "trainer": "nlvr2",
    "random_baseline_score": 50.0,
}

snli_ve_config = {
    "task_name": "SNLI-VE",
    "data_dir": "snli-ve/",
    "images_source": "flickr30k",
    "splits": ["train", "dev", "test"],
    "num_labels": 3,
    "num_images": 1,
    "model_type": "classification",
    "num_epochs": 5,
    "lr": 5e-5,
    "weight_decay": 1e-2,
    "adam_epsilon": 1e-8,
    "warmup_ratio": 0.1,
    "trainer": "snli-ve",
    "random_baseline_score": 33.33,
}

vcr_config = {
    "task_name": "VCR",
    "data_dir": "vcr/",
    "splits": ["train", "dev", "test"],
    "num_labels": 4,
    "num_images": 1,
    "model_type": "multi-choice",
    "task_type": "qa",
    "num_choices": 4,
    "num_epochs": 10,
    "lr": 1e-4,
    "weight_decay": 1e-2,
    "adam_epsilon": 1e-8,
    "warmup_ratio": 0.1,
    "trainer": "vcr",
    "random_baseline_score": 25.0,
}

# --- Phase II: language-only tasks (reference task_configs.py:104-170) ------


def _language_config(task_name, data_dir, max_len, num_labels):
    return {
        "task_name": task_name,
        "data_dir": data_dir,
        "max_len": max_len,
        "num_labels": num_labels,
        "model_type": "classification",
        "num_epochs": 10,
        "lr": 4e-5,
        "weight_decay": 1e-2,
        "adam_epsilon": 1e-8,
        "warmup_ratio": 0.1,
    }


imdb_config = _language_config("imdb", None, 160, 2)
sst2_config = _language_config("sst2", None, 40, 2)
hellaswag_config = _language_config("hellaswag", "hellaswag", 120, 4)
commonsenseqa_config = _language_config("commonsenseqa", "commonsenseqa", 80, 5)
piqa_config = _language_config("piqa", "piqa", 80, 2)

task_configs = {
    "vqa": vqa_config,
    "nlvr2": nlvr_config,
    "snli-ve": snli_ve_config,
    "vcr": vcr_config,
    "imdb": imdb_config,
    "sst2": sst2_config,
    "hellaswag": hellaswag_config,
    "piqa": piqa_config,
    "commonsenseqa": commonsenseqa_config,
}
