"""climb_tpu_torch's Phase II language data and the language driver on real
(file) data against climb_tpu's on the CPU.

Each processor reads files fabricated here in its task's layout (PIQA,
HellaSwag, CommonsenseQA, CosmosQA, IMDb, SST-2) and gives the JAX package's
examples and train/dev split; ``LanguageDataset`` keeps the JAX package's
n-shot selection (the global numpy generator, drawn in the same order) and
gives the same encodings, multiple-choice pairs included. ``cli.train_language``
without ``--synthetic`` gives the JAX driver's results JSON on a piqa and an
imdb root, the port starting from the JAX driver's initial parameters. IMDb
and SST-2 are read from local files only: without them the port raises
``FileNotFoundError`` naming the file (the JAX package would go to the HF
hub, which no test here lets it reach).
"""

import csv
import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import climb_tpu.models.vilt as jax_vilt
import climb_tpu.train.downstream as jax_downstream
from climb_tpu.cli.train_language import main as jax_main
from climb_tpu.data.language import PROCESSOR_MAP as JAX_PROCESSORS
from climb_tpu.data.language import build_language_dataset as jax_build
from climb_tpu.data.tokenization import load_tokenizer as jax_load_tokenizer
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.cli import train_language as port
from climb_tpu_torch.data.language import PROCESSOR_MAP, build_language_dataset
from climb_tpu_torch.data.language.text_processors import IMDBProcessor
from climb_tpu_torch.data.tokenization import load_tokenizer
from climb_tpu_torch.models import heads
from test_torch_data_common import (  # noqa: F401
    jax_native_route,
    jit_flax_init,
    share_jax_eval_steps,
)

torch.set_num_threads(1)


SCORE_ATOL = 1e-9  # the same predictions on the same examples: equal scores
WORDS = ("the a man woman dog cat goes runs sits eats water food quickly slowly good bad "
         "movie film great awful plot story why how what which put cup pan oven heat").split()
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", "?", ","] + WORDS
DIRS = {"piqa": "piqa", "hellaswag": "hellaswag", "commonsenseqa": "commonsenseqa",
        "cosmosqa": "cosmosqa", "imdb": "imdb", "sst2": "sst2"}
N_TRAIN, N_TEST = 40, 10
# (max_len, n_shot, seed) of each task's LanguageDataset held against JAX's
DATASETS = {"piqa": (80, 16, 3), "hellaswag": (48, 8, 1), "commonsenseqa": (40, 10, 0),
            "cosmosqa": (64, 6, 2), "imdb": (96, 5, 4), "sst2": (40, 6, 9)}


def _text(rng, lo=4, hi=20, end="."):
    return " ".join(WORDS[i] for i in rng.randint(0, len(WORDS), rng.randint(lo, hi))) + end


def _jsonl(path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def fabricate_language_root(root, seed=0):
    """Each task's files under root/<task>: N_TRAIN training and N_TEST
    original-dev rows, and the vocab of WORDS."""
    rng = np.random.RandomState(seed)
    root = Path(root)
    for split, n in (("train", N_TRAIN), ("valid", N_TEST)):
        _jsonl(root / "piqa" / f"{split}.jsonl",
               [{"goal": _text(rng, end="?"), "sol1": _text(rng), "sol2": _text(rng)}
                for _ in range(n)])
        (root / "piqa" / f"{split}-labels.lst").write_text(
            "\n".join(str(rng.randint(2)) for _ in range(n)) + "\n")
    for split, n in (("train", N_TRAIN), ("val", N_TEST)):
        _jsonl(root / "hellaswag" / f"hellaswag_{split}.jsonl",
               [{"ctx": _text(rng), "endings": [_text(rng, 2, 8) for _ in range(4)],
                 "label": int(rng.randint(4))} for _ in range(n)])
    for split, n in (("train", N_TRAIN), ("dev", N_TEST)):
        _jsonl(root / "commonsenseqa" / f"{split}_rand_split.jsonl",
               [{"question": {"stem": _text(rng, end="?"),
                              "choices": [{"label": c, "text": _text(rng, 1, 4, "")}
                                          for c in "ABCDE"]},
                 "answerKey": "ABCDE"[rng.randint(5)]} for _ in range(n)])
    (root / "cosmosqa").mkdir()
    for split, n in (("train", N_TRAIN), ("valid", N_TEST)):
        with open(root / "cosmosqa" / f"{split}.csv", "w", newline="") as f:
            csv.writer(f).writerows(
                [("id", "context", "question", "answer0", "answer1", "answer2", "answer3",
                  "label")] +
                [(f"{split}-{i}", _text(rng, 8, 30), _text(rng, end="?"),
                  *(_text(rng, 2, 6) for _ in range(4)), str(rng.randint(4)))
                 for i in range(n)])
    for split, n in (("train", N_TRAIN), ("test", N_TEST)):
        _jsonl(root / "imdb" / f"imdb_{split}.jsonl",
               [{"text": _text(rng, 20, 120), "label": i % 2} for i in range(n)])
    for split, n in (("train", N_TRAIN), ("validation", N_TEST)):
        _jsonl(root / "sst2" / f"sst2_{split}.jsonl",
               [{"sentence": _text(rng), "label": int(rng.randint(2)), "idx": i}
                for i in range(n)])
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return fabricate_language_root(tmp_path_factory.mktemp("language") / "root")


def _processor(table, task, data_dir):
    cls = table[task]
    return cls(data_dir=str(data_dir)) if task in ("imdb", "sst2") else cls()


@pytest.mark.parametrize("task", list(DIRS))
def test_processor_matches_jax(root, task):
    data_dir = root / DIRS[task]
    got, ref = _processor(PROCESSOR_MAP, task, data_dir), _processor(JAX_PROCESSORS, task,
                                                                      data_dir)
    n_dev = int(0.3 * N_TRAIN)
    for split, n in (("train", N_TRAIN - n_dev), ("dev", n_dev), ("test", N_TEST)):
        a = getattr(got, f"get_{split}_examples")(str(data_dir))
        b = getattr(ref, f"get_{split}_examples")(str(data_dir))
        assert a == b and len(a) == n, split
    assert got.dev_ids == ref.dev_ids


@pytest.mark.parametrize("task", list(DIRS))
def test_language_dataset_matches_jax(root, task, jax_native_route):  # noqa: F811
    max_len, n_shot, seed = DATASETS[task]
    vocab = str(root / "vocab.txt")
    tok, jax_tok = load_tokenizer(vocab_path=vocab), jax_load_tokenizer(vocab_path=vocab)
    assert type(tok).__name__ == type(jax_tok).__name__ == "NativeWordPieceTokenizer"
    for split in ("train", "val", "test"):
        kw = dict(n_shot=n_shot, seed=seed) if split == "train" else {}
        got = build_language_dataset(task, str(root / DIRS[task]), split, max_len,
                                     tokenizer=tok, **kw)
        ref = jax_build(task, str(root / DIRS[task]), split, max_len, tokenizer=jax_tok, **kw)
        assert got.data == ref.data and len(got) == len(ref), split
        if split == "train":
            assert got.sel_ids == ref.sel_ids
            assert len(got) == (n_shot if got.is_mc else 2 * n_shot)
        for i in range(len(got)):
            a, b = got[i], ref[i]
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (split, i, k)
    ex = got[0]
    if got.is_mc:  # (choices, max_len) pair encodings: the second segment's type is 1
        assert ex["input_ids"].shape == (len(got.data[0]["text_b"]), max_len)
        assert ex["token_type_ids"].max() == 1
    else:
        assert ex["input_ids"].shape == (max_len,)


def test_imdb_without_local_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="imdb_train.jsonl"):
        IMDBProcessor(data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="imdb_train.jsonl"):
        IMDBProcessor(data_dir=None)  # imdb's task config names no directory
    with pytest.raises(FileNotFoundError, match="sst2_validation.jsonl"):
        (tmp_path / "sst2_train.jsonl").write_text('{"sentence": "a", "label": 0}\n')
        PROCESSOR_MAP["sst2"](data_dir=str(tmp_path))


RUNS = {
    "piqa": ["--task_name", "piqa", "--num_shot", "8", "--task_config_overrides",
             "piqa.num_epochs=2,piqa.lr=1e-3"],
    "imdb": ["--task_name", "imdb", "--num_shot", "4", "--task_config_overrides",
             "imdb.num_epochs=2,imdb.lr=1e-3,imdb.data_dir=imdb"],
}


def _argv(root, out_dir, run):
    return ["--encoder_name", "vilt", "--checkpoint_name", "scratch",
            "--pretrained_model_name", "scratch", "--tiny", "--climb_data_dir", str(root),
            "--vocab_path", str(Path(root) / "vocab.txt"), "--batch_size", "8", "--seed", "5",
            "--subsample_seed", "10", "--output_dir", str(out_dir), *RUNS[run]]


@pytest.mark.parametrize("run", list(RUNS))
def test_language_driver_on_files_matches_jax(run, root, tmp_path, monkeypatch,
                                              jax_native_route):  # noqa: F811
    """The results JSON of both drivers without --synthetic; the port's
    classifier starts from the JAX driver's initial parameters, and the
    multiple-choice head's dropout is off in both (their generators differ)."""
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    made = {}
    jax_train, port_train = jax_downstream.train_downstream, port.train_downstream

    def jax_recording(args, module, params, *a, **kw):
        made["params"] = jax.tree_util.tree_map(np.asarray, params)
        return jax_train(args, module, params, *a, **kw)

    def port_from_jax(args, model, task_config, datasets, *a, **kw):
        model.load_state_dict(state_dict_from_jax(made["params"]))
        made["sizes"] = [len(d) for d in datasets]
        made["seq_len"] = model.cfg.seq_len
        return port_train(args, model, task_config, datasets, *a, **kw)

    jit_flax_init(monkeypatch)
    share_jax_eval_steps(monkeypatch)
    monkeypatch.setattr(jax_downstream, "train_downstream", jax_recording)
    monkeypatch.setattr(port, "train_downstream", port_from_jax)
    monkeypatch.setattr(jax_vilt, "MultiChoiceHead",
                        functools.partial(jax_vilt.MultiChoiceHead, dropout_rate=0.0))
    monkeypatch.setattr(heads.MultiChoiceHead, "dropout_rate", 0.0)

    jax_main(_argv(root, tmp_path / "jax", run))
    out_fn = port.main(_argv(root, tmp_path / "port", run) + ["--device", "cpu"])
    name = f"{run}_scratch_results.json"
    assert Path(out_fn) == tmp_path / "port" / name
    ref = json.loads((tmp_path / "jax" / name).read_text())
    got = json.loads(Path(out_fn).read_text())
    nshot = f"nshot-{RUNS[run][3]}"
    assert got.keys() == ref.keys() == {nshot}
    (test, dev, epoch), (rtest, rdev, repoch) = got[nshot]["seed-10"], ref[nshot]["seed-10"]
    assert epoch == repoch == 2
    np.testing.assert_allclose([test, dev], [rtest, rdev], atol=SCORE_ATOL)
    n_train = 8
    assert made["sizes"] == [n_train, int(0.3 * N_TRAIN), N_TEST]
    # max_len 80 (piqa) and 160 (imdb) reallocate: that many text slots and a 128x128 image
    assert made["seq_len"] == (80 if run == "piqa" else 160) + 1 + 16
