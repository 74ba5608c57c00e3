"""The test suite does not wait on the Hugging Face hub.

Where no local file is given, the JAX package looks ``bert-base-uncased``
(``data/tokenization.py:262-266 load_tokenizer``), ``dandelin/vilt-b32-mlm``
and the imdb and glue datasets up on the hub. Without a network each lookup
waits out connection timeouts and retries before the JAX code takes its
fallback (``HashTokenizer``, the seed's weights, ``FileNotFoundError``):
``tests/test_phase2_drivers.py::test_predict_from_raw_jsonl`` spent most of
its time so, idle, on the slowest worker of the suite. Every
pytest-xdist worker imports this module while it collects the suite, before
any test runs, so ``hub_offline`` below is in force for every test: the
libraries' offline switches, which they read from the environment when first
imported and, for a library an earlier module already imported, from their
module values at each call. The code under test takes the same fallback at
once and never reaches out. The port itself never looks anything up
(``climb_tpu_torch/models/hf_snapshot.py`` reads the local cache only).
"""

import os
import sys
import time

import pytest

OFFLINE_ENV = {"HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1", "HF_DATASETS_OFFLINE": "1"}


def hub_offline():
    os.environ.update(OFFLINE_ENV)
    if "huggingface_hub.constants" in sys.modules:
        sys.modules["huggingface_hub.constants"].HF_HUB_OFFLINE = True
    if "transformers.utils.hub" in sys.modules:
        sys.modules["transformers.utils.hub"]._is_offline_mode = True
    if "datasets.config" in sys.modules:
        sys.modules["datasets.config"].HF_DATASETS_OFFLINE = True
        sys.modules["datasets.config"].HF_HUB_OFFLINE = True


hub_offline()


def test_hub_lookups_fail_at_once(tmp_path, monkeypatch):
    """Each library is offline, and a name in no cache fails within seconds
    (with sockets to the outside closed, in case a switch were missed); the
    JAX tokenizer then falls back to the hash tokenizer, as it does without
    a network."""
    import huggingface_hub.constants
    import transformers
    import transformers.utils.hub

    from climb_tpu.data import tokenization as jax_tokenization
    from test_torch_hf_common import no_network

    no_network(monkeypatch)
    monkeypatch.setattr(transformers.utils.hub, "TRANSFORMERS_CACHE", str(tmp_path))
    assert all(os.environ[k] == v for k, v in OFFLINE_ENV.items())
    assert huggingface_hub.constants.HF_HUB_OFFLINE
    assert transformers.utils.hub.is_offline_mode()
    t0 = time.perf_counter()
    with pytest.raises(Exception):  # transformers 4.57 gives a TypeError offline
        transformers.BertTokenizerFast.from_pretrained("bert-base-uncased")
    assert isinstance(jax_tokenization.load_tokenizer(), jax_tokenization.HashTokenizer)
    assert time.perf_counter() - t0 < 10.0
