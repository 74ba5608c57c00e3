"""The language-only task datasets of Phase II (PIQA, HellaSwag,
CommonsenseQA, CosmosQA, IMDb, SST-2) from their files."""

from climb_tpu_torch.data.language.text_dataset import LanguageDataset, build_language_dataset
from climb_tpu_torch.data.language.text_processors import (
    PROCESSOR_MAP,
    COSMOSQAProcessor,
    CommonsenseQAProcessor,
    DataProcessor,
    GLUEProcessor,
    HellaSwagProcessor,
    IMDBProcessor,
    PIQAProcessor,
    split_train_dev,
)

__all__ = [
    "DataProcessor",
    "HellaSwagProcessor",
    "PIQAProcessor",
    "CommonsenseQAProcessor",
    "COSMOSQAProcessor",
    "IMDBProcessor",
    "GLUEProcessor",
    "PROCESSOR_MAP",
    "split_train_dev",
    "LanguageDataset",
    "build_language_dataset",
]
