"""``load_tokenizer`` from a Hugging Face snapshot: the port reads the
snapshot's ``vocab.txt`` and ``tokenizer_config.json`` itself; the JAX package
loads ``BertTokenizerFast.from_pretrained`` (``climb_tpu/data/tokenization.py:262-266``).
On fuzzed single texts and pairs, with and without truncation, the ids,
attention mask and token types must be equal: for the snapshot directory and
for the hub name ``bert-base-uncased`` in an offline cache, lower-casing (the
native WordPiece) and cased (the Python one)."""

import numpy as np
import pytest

from climb_tpu.data import tokenization as jax_tokenization
from climb_tpu_torch.data import tokenization
from climb_tpu_torch.data.tokenization import WordPieceTokenizer
from climb_tpu_torch.native import NativeWordPieceTokenizer
from test_torch_hf_common import no_network, offline_hub, snapshot_dir, write_vocab

SPECIALS = ["[PAD]"] + [f"[unused{i}]" for i in range(4)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
WORDS = ("a an the man woman dog cat sits on mat is are playing ball in park red blue green "
         "two people riding horse beach water near tall building play ##s ##ing ##ed ##er "
         "##ly un ##able re ##do caf ##e naive resume über ##ung 東 京 the ##re").split()
CASED = ("The Man Dog Paris London NASA Über Café ##S ##Ing").split()
PUNCT = list(".,!?;:'\"()-[]/&$%#@*")
FUZZ_PIECES = WORDS[:30] + CASED + PUNCT + [
    "[SEP]", "[MASK]", "[UNK]", "café", "CAFÉ", "naïve", "résumé", "東京", "日本語", "ß",
    "x" * 120, "12", "3.5", "\t", "\n", " ", "​", "\x07", "é", "İstanbul",
    "don't", "U.S.A.", "e-mail", "😀", "ﬁ", "Ⅻ", "  "]


def _vocab(cased: bool):
    extra = CASED if cased else []
    return SPECIALS + PUNCT + list("abcdefghijklmnopqrstuvwxyz") + [
        "##" + c for c in "abcdefghijklmnopqrstuvwxyz"] + WORDS + extra + ["東", "京", "é"]


def _texts(seed: int, n: int):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = int(rng.randint(0, 24))
        parts = [FUZZ_PIECES[i] for i in rng.randint(0, len(FUZZ_PIECES), k)]
        seps = [" ", "", " ", "  "]
        out.append("".join(p + seps[int(rng.randint(0, len(seps)))] for p in parts)
                   if rng.rand() > 0.05 else "")
    return out


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    lower = snapshot_dir(root / "hub", "bert-base-uncased")
    write_vocab(lower, _vocab(False), do_lower_case=True)
    cased = root / "cased"
    cased.mkdir()
    write_vocab(str(cased), _vocab(True), do_lower_case=False)
    return {"hub": root / "hub", "lower": lower, "cased": str(cased)}


def _equal(port, ref, texts, pairs, max_len):
    for i, text in enumerate(texts):
        pair = None if pairs is None else pairs[i]
        got, want = port.encode(text, max_len, pair), ref.encode(text, max_len, pair)
        for g, w, what in zip(got, want, ("ids", "mask", "types")):
            assert g.dtype == w.dtype and np.array_equal(g, w), (what, text, pair, g, w)


@pytest.mark.parametrize("form", ["dir", "hub", "cased"])
def test_snapshot_tokenizer_matches_bert_tokenizer_fast(form, snapshots, monkeypatch):
    offline_hub(monkeypatch, snapshots["hub"])
    spec = {"dir": snapshots["lower"], "hub": "bert-base-uncased",
            "cased": snapshots["cased"]}[form]
    port, ref = tokenization.load_tokenizer(spec), jax_tokenization.load_tokenizer(spec)
    assert type(ref).__name__ == "_HFTokenizerAdapter"  # BertTokenizerFast, not a fallback
    assert isinstance(port, WordPieceTokenizer if form == "cased" else NativeWordPieceTokenizer)
    texts = _texts(0, 300)
    for max_len in (40, 12):
        _equal(port, ref, texts, None, max_len)
        _equal(port, ref, texts, _texts(1, 300), max_len)


def test_python_wordpiece_matches_on_the_lower_casing_snapshot(snapshots, monkeypatch):
    """The Python WordPiece, which stands in where the native library did not
    build, on the same snapshot."""
    offline_hub(monkeypatch, snapshots["hub"])
    ref = jax_tokenization.load_tokenizer(snapshots["lower"])
    port = WordPieceTokenizer.from_vocab_file(snapshots["lower"] + "/vocab.txt")
    texts = _texts(2, 200)
    _equal(port, ref, texts, _texts(3, 200), 24)
    _equal(port, ref, texts, None, 24)


def test_vocab_file_first_and_hash_fallback(snapshots, tmp_path, monkeypatch, caplog):
    """A vocab file comes before the snapshot; with neither, the hash
    tokenizer and JAX's warning."""
    no_network(monkeypatch)
    monkeypatch.setenv("HF_HUB_CACHE", str(snapshots["hub"]))
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(SPECIALS + ["zebra"]) + "\n")
    tok = tokenization.load_tokenizer("bert-base-uncased", vocab_path=str(vocab))
    assert tok.encode("zebra man", 6)[0].tolist() == [6, 9, 5, 7, 0, 0]
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with caplog.at_level("WARNING"):
        tok = tokenization.load_tokenizer("bert-base-uncased")
    assert isinstance(tok, tokenization.HashTokenizer)
    assert "no vocab file, no HF cache" in caplog.text
