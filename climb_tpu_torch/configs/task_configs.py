"""Task registry: the four Phase I vision-language tasks with their low-shot
variants, and the Phase II language-only and vision-only tasks.

The port's own copy of ``climb_tpu/configs/task_configs.py`` (values
identical, reference ``src/configs/task_configs.py:16-220``). Trainers are
named by the string ``trainer`` and looked up through
``climb_tpu_torch.train.trainers.get_task_trainer_class``.
"""

SUPPORTED_VL_TASKS = ["vqa", "nlvr2", "snli-ve", "vcr"]

mscoco_config = {
    "data_dir": "ms-coco/",
}

flickr_config = {
    "data_dir": "flickr30k/",
}

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
    "low_shot_config": {
        "trainer": "low_shot_vqa",
        "type": "percentage",
        "percentage": 0.05,
        "eval_epochs": [6, 8, 10],
    },
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
    "low_shot_config": {
        "trainer": "low_shot_nlvr2",
        "type": "n-shot-per-class",
        "num_shots_per_class": 2048,
        "eval_epochs": [6, 8, 10],
    },
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
    "low_shot_config": {
        "trainer": "low_shot_snli-ve",
        "type": "n-shot-per-class",
        "num_shots_per_class": 2048,
        "eval_epochs": [2, 4, 5],
    },
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
    "low_shot_config": {
        "trainer": "low_shot_vcr",
        "type": "percentage",
        "percentage": 0.05,
        "eval_epochs": [2, 4, 6, 8, 10],
    },
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

# --- Phase II: vision-only tasks (reference task_configs.py:173-220) --------


def _vision_config(task_name, data_dir, num_labels, num_epochs):
    return {
        "task_name": task_name,
        "data_dir": data_dir,
        "num_labels": num_labels,
        "model_type": "classification",
        "num_epochs": num_epochs,
        "lr": 1e-4,
        "weight_decay": 1e-2,
        "adam_epsilon": 1e-8,
        "warmup_ratio": 0.1,
    }


imagenet_config = _vision_config("imagenet", "ILSVRC2012", 1000, 8)
places365_config = _vision_config("places365", "Places365", 365, 10)
inat2019_config = _vision_config("inat2019", "iNat2019", 1010, 8)
coco_cls_config = _vision_config("coco", "ms-coco", 80, 10)

task_configs = {
    "ms-coco": mscoco_config,
    "flickr30k": flickr_config,
    "vqa": vqa_config,
    "nlvr2": nlvr_config,
    "snli-ve": snli_ve_config,
    "vcr": vcr_config,
    "imdb": imdb_config,
    "sst2": sst2_config,
    "hellaswag": hellaswag_config,
    "piqa": piqa_config,
    "commonsenseqa": commonsenseqa_config,
    "imagenet": imagenet_config,
    "places365": places365_config,
    "inat2019": inat2019_config,
    "coco-cls": coco_cls_config,
}
