"""Tokenizers.

The reference leans on the external SentencePiece T5Tokenizer
(lceT5.py:5, pairwrapper.py:80-84). This environment has no network and no
sentencepiece module, so the framework ships its own stack:

- ``HashTokenizer`` — deterministic hashing tokenizer for tests/benchmarks.
- ``TrainedTokenizer`` — a real subword tokenizer trained in-repo on the
  corpus via the ``tokenizers`` library (Unigram, the same family as T5's
  sentencepiece model), with save/load.
- ``load_hf_tokenizer`` — wraps a *local* HF tokenizer directory when real
  t5 vocab parity is needed (e.g. imported checkpoints).

All tokenizers expose the same minimal protocol: encode, vocab_size, pad_id,
eos_id, and the two verbalizer ids for "true"/"false" that monoT5 scoring
needs (reference old/eta_bound.py:45-46).
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterable, Protocol, Sequence

import numpy as np


class Tokenizer(Protocol):
    vocab_size: int
    pad_id: int
    eos_id: int
    true_id: int
    false_id: int

    def encode(self, text: str, add_eos: bool = False) -> list[int]: ...


def pad_batch(
    seqs: Sequence[Sequence[int]],
    max_len: int,
    pad_id: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad/truncate to (B, max_len) int32 ids + int32 {0,1} mask."""
    out = np.full((len(seqs), max_len), pad_id, np.int32)
    mask = np.zeros((len(seqs), max_len), np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[:max_len]
        out[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return out, mask


class HashTokenizer:
    """Whitespace + stable-hash tokenizer. Vocabulary-free, deterministic
    across processes (uses md5, not Python's salted hash)."""

    def __init__(self, vocab_size: int = 8192):
        if vocab_size < 16:
            raise ValueError("vocab_size too small")
        self.vocab_size = vocab_size
        self.pad_id = 0
        self.eos_id = 1
        self.unk_id = 2
        self.true_id = 3
        self.false_id = 4
        self._n_special = 5

    def _word_id(self, w: str) -> int:
        if w == "true":
            return self.true_id
        if w == "false":
            return self.false_id
        h = int.from_bytes(hashlib.md5(w.lower().encode()).digest()[:4], "little")
        return self._n_special + h % (self.vocab_size - self._n_special)

    def encode(self, text: str, add_eos: bool = False) -> list[int]:
        ids = [self._word_id(w) for w in text.split()]
        if add_eos:
            ids.append(self.eos_id)
        return ids


class TrainedTokenizer:
    """Unigram subword tokenizer trained on the corpus (tokenizers lib).

    Replaces the reference's downloaded sentencepiece model with an in-repo
    artifact: ``TrainedTokenizer.train(texts, vocab_size).save(path)``.
    """

    # <true>/<false> are dedicated verbalizer tokens: guaranteed single-token
    # labels for first-position scoring (a subword tokenizer would split the
    # words "true"/"false"), and they can never occur in document text so
    # prompts are unaffected. The monoT5 scoring head only needs two distinct
    # label ids — the English words matter only for *pretrained* T5 vocab,
    # which uses the HF adapter below instead.
    SPECIALS = ["<pad>", "</s>", "<unk>", "<true>", "<false>"]

    def __init__(self, tok, vocab_size: int):
        self._tok = tok
        self.vocab_size = vocab_size
        self.pad_id = tok.token_to_id("<pad>")
        self.eos_id = tok.token_to_id("</s>")
        self.true_id = tok.token_to_id("<true>")
        self.false_id = tok.token_to_id("<false>")
        if self.true_id is None or self.false_id is None:
            # tokenizer trained before verbalizer specials existed:
            # fall back to first-subword ids
            self.true_id = tok.encode("true").ids[0]
            self.false_id = tok.encode("false").ids[0]

    @classmethod
    def train(
        cls, texts: Iterable[str], vocab_size: int = 8192
    ) -> "TrainedTokenizer":
        from tokenizers import Tokenizer as HFTokenizer
        from tokenizers import decoders, models, pre_tokenizers, trainers

        tok = HFTokenizer(models.Unigram())
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        tok.decoder = decoders.Metaspace()
        trainer = trainers.UnigramTrainer(
            vocab_size=vocab_size,
            special_tokens=list(cls.SPECIALS),
            unk_token="<unk>",
        )
        tok.train_from_iterator(texts, trainer=trainer)
        return cls(tok, tok.get_vocab_size())

    def encode(self, text: str, add_eos: bool = False) -> list[int]:
        ids = self._tok.encode(text).ids
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def encode_batch(self, texts: Sequence[str]) -> list[list[int]]:
        """Rust-side batch encode — one FFI call instead of len(texts)
        Python round trips; the MS MARCO-scale ingest path depends on it
        (scripts/scale_ingest_rehearsal.py measures the difference)."""
        return [e.ids for e in self._tok.encode_batch(list(texts))]

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._tok.save(path)

    def save_sentencepiece(self, path: str) -> None:
        """Also exportable as a standard sentencepiece ``spiece.model``
        (the reference's tokenizer artifact format — data/spm_export.py)."""
        from pacednegatives_tpu_torch.data.spm_export import export_sentencepiece

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        export_sentencepiece(self, path)

    @classmethod
    def load(cls, path: str) -> "TrainedTokenizer":
        from tokenizers import Tokenizer as HFTokenizer

        tok = HFTokenizer.from_file(path)
        return cls(tok, tok.get_vocab_size())


class HFWrappedTokenizer:
    """Adapter for a local transformers tokenizer directory (t5 vocab parity
    when an offline checkpoint is mounted)."""

    def __init__(self, hf_tok):
        self._tok = hf_tok
        self.vocab_size = hf_tok.vocab_size
        self.pad_id = hf_tok.pad_token_id
        self.eos_id = hf_tok.eos_token_id
        self.true_id = hf_tok.encode("true")[0]
        self.false_id = hf_tok.encode("false")[0]

    def encode(self, text: str, add_eos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_eos:
            ids.append(self.eos_id)
        return ids


def load_hf_tokenizer(path: str) -> HFWrappedTokenizer:
    from transformers import AutoTokenizer

    return HFWrappedTokenizer(AutoTokenizer.from_pretrained(path))
