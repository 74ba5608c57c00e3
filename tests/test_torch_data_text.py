"""The port's text side of the data path against the JAX package: WordPiece
ids (Python and native), the hash tokenizer, ``truncate_pair``,
``load_tokenizer``'s resolution order, the VQA utilities and answer
normalization; and the native build's reports. Every comparison is exact
(ids and masks are integers or {0, 1}; scores are the same float32 values).
"""

import pickle

import numpy as np
import pytest

import climb_tpu.data.tokenization as jax_tok
import climb_tpu.utils.vqa_utils as jax_vqa
import climb_tpu.utils.word_utils as jax_word
import climb_tpu_torch.data.tokenization as tok
import climb_tpu_torch.native as native
import climb_tpu_torch.utils.vqa_utils as vqa
import climb_tpu_torch.utils.word_utils as word
from climb_tpu_torch.native import build as native_build

VOCAB = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] a the cat dog is on mat red blue two person play ##ing "
    "run ##s what color be yes no girl boy say hello gray casey riley , . ? ! and of to "
    "in it cafe caf ##e ##é über".split()
)
TEXTS = [
    "The cat is playing on the mat!",
    "what [SEP] runs",
    "Casey says hello, dog runs.",
    "café über dog",  # non-ASCII: the native tokenizer hands it to Python
    "unknownstuff cat \t\n two",
    "",
    "a " * 60,  # longer than every max_len below
    "THE GIRL, the boy; and the DOG?!",
    "naïve Ünïcödé — “quotes” 中文 dog",
]
PAIRS = [("the cat is on the mat", "dog runs playing"),
         ("what color is the dog " * 4, "red"),
         ("two", "the girl and the boy play on the red mat " * 3)]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB), encoding="utf-8")
    return str(path)


def assert_same(a, b, what):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype, what
        np.testing.assert_array_equal(x, y, err_msg=what)


@pytest.mark.parametrize("max_len", [8, 16, 40])
def test_wordpiece_ids_match_jax(vocab_file, max_len):
    ref = jax_tok.WordPieceTokenizer.from_vocab_file(vocab_file)
    py = tok.WordPieceTokenizer.from_vocab_file(vocab_file)
    nat = native.NativeWordPieceTokenizer(vocab_file)
    for text in TEXTS:
        want = ref.encode(text, max_len)
        assert_same(py.encode(text, max_len), want, f"python {text!r}")
        assert_same(nat.encode(text, max_len), want, f"native {text!r}")
    for a, b in PAIRS:
        want = ref.encode(a, max_len, b)
        assert_same(py.encode(a, max_len, b), want, f"python pair {a!r}")
        assert_same(nat.encode(a, max_len, b), want, f"native pair {a!r}")
    assert_same(nat.batch_encode(TEXTS, max_len), ref.batch_encode(TEXTS, max_len), "batch")


def test_truncate_pair_and_hash_tokenizer_match_jax():
    for la in range(0, 12):
        for lb in range(0, 12):
            a, b = list(range(la)), list(range(100, 100 + lb))
            for budget in (0, 3, 7, 10):
                assert tok.truncate_pair(a, b, budget) == jax_tok.truncate_pair(a, b, budget)
    ref, got = jax_tok.HashTokenizer(), tok.HashTokenizer()
    for text in TEXTS:
        assert_same(got.encode(text, 16), ref.encode(text, 16), text)
    assert_same(got.encode("a b c", 8, "d e f g h"), ref.encode("a b c", 8, "d e f g h"), "pair")


def test_load_tokenizer_resolution(vocab_file, caplog):
    assert isinstance(tok.load_tokenizer("synthetic"), tok.HashTokenizer)
    assert isinstance(tok.load_tokenizer(vocab_path=vocab_file), native.NativeWordPieceTokenizer)
    # a spec that is a file path is a vocab file too
    assert isinstance(tok.load_tokenizer(vocab_file), native.NativeWordPieceTokenizer)
    # no vocab file and no local HF cache: the hash tokenizer, with the warning
    with caplog.at_level("WARNING"):
        fallback = tok.load_tokenizer("no-such-tokenizer-in-any-cache")
    assert isinstance(fallback, tok.HashTokenizer)
    assert "falling back to HashTokenizer" in caplog.text


def test_missing_or_broken_toolchain_leaves_the_step_to_python(vocab_file, tmp_path,
                                                               monkeypatch):
    """No g++: every library is reported missing and the Python tokenizer,
    PIL decode and resize take over. A source that does not compile is
    reported as a failure, not as a missing toolchain."""
    monkeypatch.setattr(native, "_libs", None)
    monkeypatch.setattr(native_build, "status", {})
    monkeypatch.setattr(native_build, "DEFAULT_BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    assert native.native_available() == {"tokenizer": False, "image": False, "jpeg": False}
    assert all(s.startswith("no toolchain") for s in native_build.status.values())
    assert isinstance(tok.load_tokenizer(vocab_path=vocab_file), tok.WordPieceTokenizer)
    assert native.resize_into_canvas(np.zeros((4, 4, 3), np.uint8), (2, 2), (4, 4)) is None
    assert native.jpeg_dims(b"\xff\xd8") is None

    src = tmp_path / "src"
    src.mkdir()
    for _, source, _ in native_build.TARGETS:
        (src / source).write_bytes((native_build.HERE / source).read_bytes())
    (src / "tokenizer.cpp").write_text("this is not C++\n")
    monkeypatch.undo()
    monkeypatch.setattr(native_build, "HERE", src)
    monkeypatch.setattr(native_build, "status", {})
    paths = native_build.build(tmp_path / "broken")
    assert paths["tokenizer"] is None
    assert native_build.status["tokenizer"].startswith("failed:")
    assert paths["image"] is not None and native_build.status["image"] == "built"


def test_vqa_utils_and_normalize_word_match_jax(tmp_path):
    for n in range(0, 12):
        assert vqa.get_score(n) == jax_vqa.get_score(n)
    rng = np.random.RandomState(0)
    for _ in range(5):
        labels = rng.choice(50, size=rng.randint(0, 6), replace=False).tolist()
        scores = [vqa.get_score(int(c)) for c in rng.randint(1, 10, size=len(labels))]
        got, want = vqa.target_vector(50, labels, scores), jax_vqa.target_vector(50, labels, scores)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    answers = ["Two", "two.", "the dog", "a red, blue cat", "1,000", "isnt it", "yes!",
               "ten (10)", "dont", "3.5", "no; none", "Hello/World", "an apple", "it's"]
    for a in answers:
        assert word.normalize_word(a) == jax_word.normalize_word(a), a

    import json

    for split in ("train", "val"):
        annos = [{"multiple_choice_answer": answers[i % len(answers)]} for i in range(60)]
        (tmp_path / f"v2_mscoco_{split}2014_annotations.json").write_text(
            json.dumps({"annotations": annos}))
    got = vqa.create_vqa_labels(str(tmp_path), min_occurrences=9)
    with open(tmp_path / "ans2label.pkl", "rb") as f:
        written = pickle.load(f)
    assert got == written == jax_vqa.create_vqa_labels(str(tmp_path), min_occurrences=9)
    assert got
