"""Ahead-of-time text tokenization for the host input pipeline (the port's
copy of ``climb_tpu/data/tokenization.py``).

The reference tokenizes inside the model's forward pass every step through
``ViltProcessor`` (``src/modeling/vilt.py:49,83-96``); here tokenization
happens once in the loader, into fixed-shape (ids, mask, token types) arrays.

- ``WordPieceTokenizer``: BERT-uncased-compatible WordPiece (basic tokenizer
  and greedy longest match) over a standard ``vocab.txt``. The C++ version
  (``climb_tpu_torch.native``) serves it when built; this Python version is
  the reference and the fallback.
- ``HashTokenizer``: a deterministic hash tokenizer for synthetic and test
  pipelines (no vocab file).
- ``load_tokenizer``: a vocab file, then the Hugging Face snapshot the spec
  resolves to (its ``vocab.txt``; the JAX package's cached
  ``BertTokenizerFast`` step), then the hash tokenizer with a warning.
"""

import os
import unicodedata
from typing import List, Optional, Sequence, Tuple

import numpy as np

CLS, SEP, PAD, UNK, MASK = "[CLS]", "[SEP]", "[PAD]", "[UNK]", "[MASK]"


def truncate_pair(a, b, budget: int):
    """HF fast-tokenizer 'longest_first' pair truncation (analytic form,
    verified against BertTokenizerFast): the initially-longer sequence keeps
    max(ceil(budget/2), budget - len(other)); ties favor the pair."""
    if len(a) + len(b) <= budget:
        return a, b
    half_c = budget - budget // 2
    if len(a) > len(b):
        ka = max(half_c, budget - len(b))
        kb = budget - ka
    else:
        kb = max(half_c, budget - len(a))
        ka = budget - kb
    return a[:ka], b[:kb]



def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT basic tokenization: clean, CJK-space, lowercase+strip accents,
    split on whitespace and punctuation."""
    out_chars = []
    for ch in text:
        cp = ord(ch)
        # tab, newline and return are whitespace before they are control characters,
        # as in BertTokenizerFast (the JAX package's copy drops them)
        if ch in ("\t", "\n", "\r") or unicodedata.category(ch) == "Zs":
            out_chars.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        elif _is_chinese_char(cp):
            out_chars.append(f" {ch} ")
        else:
            out_chars.append(ch)
    text = "".join(out_chars)

    tokens = []
    for tok in text.split():
        if lowercase:
            tok = tok.lower()
            tok = "".join(
                c for c in unicodedata.normalize("NFD", tok) if unicodedata.category(c) != "Mn"
            )
        cur = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    """BERT-uncased-compatible WordPiece over a standard vocab.txt."""

    def __init__(self, vocab: dict, lowercase: bool = True, max_chars_per_word: int = 100):
        self.vocab = vocab
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    def wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    _SPECIALS_RE = None

    def tokenize_to_ids(self, text: str) -> List[int]:
        """Tokenize, honoring literal special tokens embedded in the text
        (VCR builds 'question [SEP] answer' strings, vcr_dataset.py:109-125 —
        HF fast tokenizers recognize these; so do we)."""
        import re

        if WordPieceTokenizer._SPECIALS_RE is None:
            WordPieceTokenizer._SPECIALS_RE = re.compile(
                r"(\[CLS\]|\[SEP\]|\[PAD\]|\[UNK\]|\[MASK\])"
            )
        ids = []
        for part in WordPieceTokenizer._SPECIALS_RE.split(text):
            if not part:
                continue
            if part in self.vocab and part.startswith("["):
                ids.append(self.vocab[part])
                continue
            for tok in basic_tokenize(part, self.lowercase):
                ids.extend(self.wordpiece(tok))
        return ids

    def encode(
        self,
        text: str,
        max_len: int,
        text_pair: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (input_ids, attention_mask, token_type_ids), fixed length max_len.

        Matches HF pad-to-max_length + truncation (the reference's processor
        call, vilt.py:88-93).
        """
        a = self.tokenize_to_ids(text)
        if text_pair:  # an empty pair is no pair, as in BertTokenizerFast
            b = self.tokenize_to_ids(text_pair)
            a, b = truncate_pair(a, b, max_len - 3)
            ids = [self.cls_id] + a + [self.sep_id] + b + [self.sep_id]
            types = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        else:
            a = a[: max_len - 2]
            ids = [self.cls_id] + a + [self.sep_id]
            types = [0] * len(ids)
        n = len(ids)
        input_ids = np.full((max_len,), self.pad_id, np.int32)
        input_ids[:n] = ids
        mask = np.zeros((max_len,), np.float32)
        mask[:n] = 1.0
        token_type = np.zeros((max_len,), np.int32)
        token_type[:n] = types
        return input_ids, mask, token_type

    def batch_encode(self, texts: Sequence[str], max_len: int, pairs=None):
        outs = [
            self.encode(t, max_len, None if pairs is None else pairs[i])
            for i, t in enumerate(texts)
        ]
        ids, mask, types = zip(*outs)
        return np.stack(ids), np.stack(mask), np.stack(types)


class HashTokenizer:
    """Deterministic hash tokenizer for synthetic data / tests."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self.cls_id, self.sep_id, self.pad_id, self.unk_id = 101, 102, 0, 100

    def encode(self, text: str, max_len: int, text_pair: Optional[str] = None):
        def tok(t):
            return [
                1000 + (hash(w) % (self.vocab_size - 1000)) for w in t.lower().split()
            ]

        a = tok(text)
        if text_pair is not None:
            b = tok(text_pair)
            a, b = truncate_pair(a, b, max_len - 3)
            ids = [self.cls_id] + a + [self.sep_id] + b + [self.sep_id]
            types = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        else:
            a = a[: max_len - 2]
            ids = [self.cls_id] + a + [self.sep_id]
            types = [0] * len(ids)
        n = len(ids)
        input_ids = np.full((max_len,), self.pad_id, np.int32)
        input_ids[:n] = ids
        mask = np.zeros((max_len,), np.float32)
        mask[:n] = 1.0
        token_type = np.zeros((max_len,), np.int32)
        token_type[:n] = types
        return input_ids, mask, token_type

    def batch_encode(self, texts, max_len, pairs=None):
        outs = [
            self.encode(t, max_len, None if pairs is None else pairs[i])
            for i, t in enumerate(texts)
        ]
        ids, mask, types = zip(*outs)
        return np.stack(ids), np.stack(mask), np.stack(types)


def load_tokenizer(spec: str = "bert-base-uncased", vocab_path: Optional[str] = None):
    """Resolve a tokenizer, in the JAX package's order: an explicit vocab file
    (``--vocab_path``, or ``spec`` naming one); then the Hugging Face snapshot
    ``spec`` resolves to (a directory, or a hub name in the local cache, as
    ``models.hf_snapshot.resolve_snapshot`` finds it; never downloaded): its
    ``vocab.txt``, lower-cased as its ``tokenizer_config.json`` says (default
    true), which gives the ids, mask and token types of the JAX package's
    ``BertTokenizerFast``; then the hash tokenizer, with JAX's warning. A
    lower-casing vocabulary gets the native WordPiece when its library builds,
    else the Python one."""
    if spec == "synthetic":
        return HashTokenizer()
    path, lowercase = vocab_path, True
    if path is None and os.path.isfile(spec):
        path = spec
    if path is None or not os.path.isfile(path):
        from climb_tpu_torch.models.hf_snapshot import snapshot_vocab

        found = snapshot_vocab(spec)
        if found is not None:
            path, lowercase = found
    if path is not None and os.path.isfile(path):
        if lowercase:
            try:
                from climb_tpu_torch.native import NativeWordPieceTokenizer

                return NativeWordPieceTokenizer(path)
            except (OSError, RuntimeError):  # no toolchain, or the library did not build
                pass
        return WordPieceTokenizer.from_vocab_file(path, lowercase=lowercase)
    import logging

    logging.getLogger(__name__).warning(
        "tokenizer %s unavailable (no vocab file, no HF cache); falling back to HashTokenizer "
        "— fine for synthetic runs only", spec)
    return HashTokenizer()
