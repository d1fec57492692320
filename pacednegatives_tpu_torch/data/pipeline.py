"""Host-side tokenize-once pipeline.

The reference re-tokenizes every batch inside DataLoader workers — the SAME
strings twice per step in the eta wrapper (prep_batch called from both
meta_loop and main_loop, old/eta_bound.py:62,96). Here every query and doc
is tokenized exactly once into fixed-shape arrays; batches are assembled by
integer gathers (host or device — see device_corpus.py).

Prompt layout (monoT5, reference dataloader.py:42-43):

    'Query: ' + q + ' Document: ' + d + ' Relevant:'

is tokenized as fixed segments [prefix | query (Lq) | mid | doc (Ld) |
suffix+eos]; query/doc segments are padded in place and masked out via the
attention mask. Positions are therefore fixed per segment — a deliberate
static-shape design (XLA requires static shapes; per-example repacking would
force retraces). Training and inference use the same layout, so the model is
self-consistent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pacednegatives_tpu_torch.data.corpus import TextCorpus
from pacednegatives_tpu_torch.data.tokenizer import Tokenizer


@dataclasses.dataclass(frozen=True)
class PromptTemplate:
    prefix: tuple[int, ...]  # 'Query:'
    mid: tuple[int, ...]  # 'Document:'
    suffix: tuple[int, ...]  # 'Relevant:' + eos

    @classmethod
    def monot5(cls, tok: Tokenizer) -> "PromptTemplate":
        return cls(
            prefix=tuple(tok.encode("Query:")),
            mid=tuple(tok.encode("Document:")),
            suffix=tuple(tok.encode("Relevant:", add_eos=True)),
        )

    def total_len(self, max_q: int, max_d: int) -> int:
        return len(self.prefix) + max_q + len(self.mid) + max_d + len(self.suffix)


def encode_texts(texts, tok: Tokenizer) -> list:
    """Encode a chunk of texts, choosing batched vs per-call encode.

    ``encode_batch`` is used when the tokenizer has one AND >1 CPU is
    available: the Rust `tokenizers` backend rayon-parallelizes a chunk
    across cores, but measured on 1 CPU it's ~17% SLOWER than per-call
    encode from thread-pool overhead. The gate uses the CPUs available to
    THIS process (``sched_getaffinity``): ``os.cpu_count()`` reports
    physical cores and ignores cgroup/affinity pinning, so a 1-CPU
    container on a many-core host would take the slower path. This is the
    single shared policy for both ingestion paths (in-RAM ``_encode_all``
    and ``data/streaming.py``)."""
    import os

    batched = getattr(tok, "encode_batch", None)
    try:
        avail_cpus = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # non-Linux fallback
        avail_cpus = os.cpu_count() or 1
    if batched is not None and avail_cpus > 1:
        return batched(texts)
    return [tok.encode(t) for t in texts]


def _encode_all(
    texts, tok: Tokenizer, max_len: int, chunk: int
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize ``texts`` into a preallocated (N, max_len) matrix, chunked.

    Rows are written straight into the final matrix, so peak host RAM is
    final size + one chunk of Python lists, not 2x final size the way a
    whole-corpus list-of-lists + pad_batch would be (MS MARCO scale,
    SURVEY §3.2). Batched-vs-serial encode policy: ``encode_texts``.
    """
    n = len(texts)
    out = np.full((n, max_len), tok.pad_id, np.int32)
    mask = np.zeros((n, max_len), np.int32)
    for lo in range(0, n, chunk):
        part = texts[lo : lo + chunk]
        seqs = encode_texts(part, tok)
        for i, s in enumerate(seqs):
            s = s[:max_len]
            out[lo + i, : len(s)] = s
            mask[lo + i, : len(s)] = 1
    return out, mask


def pack_rows(
    ids: np.ndarray,
    mask: np.ndarray,
    pad_id: int,
    out_len: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Compact each row's real tokens (mask == 1) to the front, preserving
    order; pads move to the tail (and are normalized to ``pad_id`` so the
    pad-derived-mask convention holds downstream). Optionally truncates to
    ``out_len`` columns — refused if that would cut a real token, because
    losing the 'Relevant:' suffix silently destroys the monoT5 prompt."""
    order = np.argsort(mask == 0, axis=1, kind="stable")
    ids_p = np.take_along_axis(ids, order, axis=1)
    mask_p = np.take_along_axis(mask, order, axis=1)
    if out_len is not None and out_len < ids.shape[1]:
        max_len = int(mask.sum(axis=1).max(initial=0))
        if max_len > out_len:
            raise ValueError(
                f"pack_rows: out_len={out_len} would truncate a row with "
                f"{max_len} real tokens (suffix loss)"
            )
        ids_p = ids_p[:, :out_len]
        mask_p = mask_p[:, :out_len]
    return np.where(mask_p == 1, ids_p, pad_id), mask_p


@dataclasses.dataclass
class TokenizedStore:
    """All queries/docs tokenized once into padded matrices.

    Masks may be ``None`` (the streaming builder, data/streaming.py, never
    materializes them): every padded position then holds ``pad_id`` by
    construction and masks are derived as ``tokens != pad_id`` on use —
    the same convention DeviceCorpus applies on device."""

    q_tokens: np.ndarray  # (Nq, Lq) int32 (or int16, streaming builder)
    q_mask: np.ndarray | None  # (Nq, Lq) int32, or None (pad-derived)
    d_tokens: np.ndarray  # (Nd, Ld) int32 (or int16)
    d_mask: np.ndarray | None
    template: PromptTemplate
    pad_id: int
    true_id: int
    false_id: int
    eos_id: int

    @classmethod
    def build(
        cls,
        corpus: TextCorpus,
        tok: Tokenizer,
        max_q_tokens: int = 32,
        max_d_tokens: int = 180,
        chunk: int = 65536,
    ) -> "TokenizedStore":
        q_tokens, q_mask = _encode_all(
            corpus.query_texts, tok, max_q_tokens, chunk
        )
        d_tokens, d_mask = _encode_all(
            corpus.doc_texts, tok, max_d_tokens, chunk
        )
        return cls(
            q_tokens=q_tokens,
            q_mask=q_mask,
            d_tokens=d_tokens,
            d_mask=d_mask,
            template=PromptTemplate.monot5(tok),
            pad_id=tok.pad_id,
            true_id=tok.true_id,
            false_id=tok.false_id,
            eos_id=tok.eos_id,
        )

    @property
    def prompt_len(self) -> int:
        return self.template.total_len(
            self.q_tokens.shape[1], self.d_tokens.shape[1]
        )

    def assemble_host(
        self, q_rows: np.ndarray, d_rows: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(B,) query rows + (B,) doc rows -> (B, L) prompt ids + mask."""
        B = len(q_rows)
        t = self.template
        ones = lambda seg: np.ones((B, len(seg)), np.int32)
        tile = lambda seg: np.tile(np.array(seg, np.int32), (B, 1))
        q_tok = self.q_tokens[q_rows].astype(np.int32, copy=False)
        d_tok = self.d_tokens[d_rows].astype(np.int32, copy=False)
        ids = np.concatenate(
            [tile(t.prefix), q_tok, tile(t.mid), d_tok, tile(t.suffix)],
            axis=1,
        )
        q_m = (
            self.q_mask[q_rows] if self.q_mask is not None
            else (q_tok != self.pad_id).astype(np.int32)
        )
        d_m = (
            self.d_mask[d_rows] if self.d_mask is not None
            else (d_tok != self.pad_id).astype(np.int32)
        )
        mask = np.concatenate(
            [ones(t.prefix), q_m, ones(t.mid), d_m, ones(t.suffix)],
            axis=1,
        )
        return ids, mask

    def assemble_host_packed(
        self,
        q_rows: np.ndarray,
        d_rows: np.ndarray,
        out_len: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Like assemble_host, but with real tokens COMPACTED to the front
        of each row (pads only at the tail), optionally truncated to
        ``out_len`` columns.

        This reproduces the reference's positional geometry exactly: it
        tokenizes the whole prompt string at once (lceT5.py:40-53), so
        query/doc/suffix tokens are contiguous with no interior pad gaps.
        The segment layout (assemble_host) is the static-shape training
        default; packed assembly is for (a) serving length-bucketed batches
        at less-than-max prompt length and (b) models whose training saw
        contiguous positions — imported pretrained checkpoints above all.
        A model must be served with the same layout it was trained with.
        """
        ids, mask = self.assemble_host(q_rows, d_rows)
        return pack_rows(ids, mask, self.pad_id, out_len=out_len)

    def pair_lengths(
        self, q_rows: np.ndarray, d_rows: np.ndarray
    ) -> np.ndarray:
        """(B,) TRUE (unpadded) prompt length per (query, doc) pair — the
        bucketing key for packed serving."""
        if not hasattr(self, "_row_lens"):
            q_m = (
                self.q_mask if self.q_mask is not None
                else self.q_tokens != self.pad_id
            )
            d_m = (
                self.d_mask if self.d_mask is not None
                else self.d_tokens != self.pad_id
            )
            t = self.template
            const = len(t.prefix) + len(t.mid) + len(t.suffix)
            # cached once: (Nq,), (Nd,) int32 true lengths
            self._row_lens = (
                q_m.sum(axis=1, dtype=np.int32),
                d_m.sum(axis=1, dtype=np.int32),
                np.int32(const),
            )
        q_len, d_len, const = self._row_lens
        return q_len[q_rows] + d_len[d_rows] + const

    def labels(self, B: int, positive: bool) -> np.ndarray:
        """(B, 2) labels [verbalizer, eos] — parity with the reference's
        tokenizer(['true']*B).input_ids (lceT5.py:50-51)."""
        tok_id = self.true_id if positive else self.false_id
        return np.tile(np.array([[tok_id, self.eos_id]], np.int32), (B, 1))
