"""Device-resident corpus: the port of data/device_corpus.py.

The whole corpus lives on the device as pre-tokenized token matrices, and
batch assembly (difficulty -> binomial sampling -> pool gather -> prompt
concat -> labels) is gathers and concatenations on that device, so a
training step needs nothing from the host but the (B,) pair indices. Token
matrices are stored as int16 when the vocab fits 15 bits (t5's 32128 does)
and widened to int64 in the gathers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pacednegatives_tpu_torch.data.pipeline import TokenizedStore
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.ops.sampling import (
    difficulty_to_index,
    sample_pool_indices_batch,
)


@dataclasses.dataclass
class DeviceCorpus:
    """Token matrices + triple/pool structure as tensors on one device.
    Masks are derived from tokens != pad_id unless stored explicitly."""

    q_tokens: torch.Tensor  # (Nq, Lq)
    q_mask: torch.Tensor | None
    d_tokens: torch.Tensor  # (Nd, Ld)
    d_mask: torch.Tensor | None
    query_rows: torch.Tensor  # (Np,) per pair
    pos_rows: torch.Tensor  # (Np,)
    pools: torch.Tensor  # (Np, n_neg), easiest first
    prefix: torch.Tensor  # (Lp,)
    mid: torch.Tensor
    suffix: torch.Tensor
    pad_id: int
    true_id: int
    false_id: int
    eos_id: int
    # ceil instead of floor for difficulty -> pool index (dataloader.py:22)
    use_max: bool = False
    # compact each prompt's real tokens to the front (the reference's
    # contiguous positional geometry); see data/device_corpus.py:71-79
    packed: bool = False

    @classmethod
    def build(cls, store: TokenizedStore, triples: TripletStore,
              device: torch.device | str = "cpu", use_max: bool = False,
              compact_tokens: bool = True, store_masks: bool = False,
              packed: bool = False) -> "DeviceCorpus":
        """Copy a host store and its triples onto ``device`` (explicit: no
        default placement), with the JAX build's checks."""
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        t = store.template
        tok_dtype = np.int32
        if compact_tokens:
            if (store.q_tokens.dtype == np.int16
                    and store.d_tokens.dtype == np.int16):
                tok_dtype = np.int16
            elif max(store.q_tokens.max(initial=0),
                     store.d_tokens.max(initial=0)) < 2**15:
                tok_dtype = np.int16
        if store_masks and (store.q_mask is None or store.d_mask is None):
            raise ValueError(
                "store_masks=True but the TokenizedStore carries no mask "
                "matrices (streaming builder); its masks are pad-derived "
                "by construction — build with store_masks=False"
            )
        if not store_masks and store.q_mask is not None:
            if not (store.q_tokens[store.q_mask == 0] == store.pad_id).all() \
                    or not (
                        store.d_tokens[store.d_mask == 0] == store.pad_id
                    ).all():
                raise ValueError(
                    "store_masks=False requires every padded position to "
                    "hold pad_id (masks are re-derived as tokens != pad_id "
                    "on device); this store has non-pad tokens at masked "
                    "positions — build with store_masks=True instead"
                )
        return cls(
            q_tokens=put(store.q_tokens.astype(tok_dtype, copy=False)),
            q_mask=put(store.q_mask.astype(np.int8)) if store_masks else None,
            d_tokens=put(store.d_tokens.astype(tok_dtype, copy=False)),
            d_mask=put(store.d_mask.astype(np.int8)) if store_masks else None,
            query_rows=put(triples.query_rows.astype(np.int64)),
            pos_rows=put(triples.pos_rows.astype(np.int64)),
            pools=put(triples.pools.astype(np.int64)),
            prefix=put(np.asarray(t.prefix, np.int64)),
            mid=put(np.asarray(t.mid, np.int64)),
            suffix=put(np.asarray(t.suffix, np.int64)),
            pad_id=store.pad_id,
            true_id=store.true_id,
            false_id=store.false_id,
            eos_id=store.eos_id,
            use_max=use_max,
            packed=packed,
        )

    @property
    def device(self) -> torch.device:
        return self.q_tokens.device

    @property
    def num_pairs(self) -> int:
        return self.query_rows.shape[0]

    @property
    def n_neg(self) -> int:
        return self.pools.shape[1]

    def _masked(self, tokens: torch.Tensor, mask_table, rows) -> torch.Tensor:
        if mask_table is not None:
            return mask_table[rows].to(torch.int32)
        return (tokens != self.pad_id).to(torch.int32)

    def assemble(self, q_rows: torch.Tensor, d_rows: torch.Tensor):
        """(B,) query rows x (B,) doc rows -> (B, L) int64 ids, int32 mask."""
        B = q_rows.shape[0]
        tile = lambda seg: seg.expand(B, seg.shape[0])
        ones = lambda seg: torch.ones((B, seg.shape[0]), dtype=torch.int32,
                                      device=seg.device)
        q_tok = self.q_tokens[q_rows].long()
        d_tok = self.d_tokens[d_rows].long()
        ids = torch.cat([tile(self.prefix), q_tok, tile(self.mid), d_tok,
                         tile(self.suffix)], dim=1)
        mask = torch.cat([
            ones(self.prefix),
            self._masked(q_tok, self.q_mask, q_rows),
            ones(self.mid),
            self._masked(d_tok, self.d_mask, d_rows),
            ones(self.suffix),
        ], dim=1)
        if self.packed:
            # compact real tokens to the front, order kept (a stable sort
            # on "is pad"); pads normalised to pad_id
            order = torch.argsort((mask == 0).to(torch.int8), dim=1,
                                  stable=True)
            ids = torch.gather(ids, 1, order)
            mask = torch.gather(mask, 1, order)
            ids = torch.where(mask == 1, ids, self.pad_id)
        return ids, mask

    def labels(self, B: int, positive: bool) -> torch.Tensor:
        tok = self.true_id if positive else self.false_id
        return torch.tensor([tok, self.eos_id], dtype=torch.int64,
                            device=self.device).expand(B, 2)

    def pair_batch(self, pair_idx: torch.Tensor, difficulty):
        """Single-negative batch at a difficulty level (reference
        TripletDataset.get_items + LevelLoader.get_batch)."""
        q = self.query_rows[pair_idx]
        pos_d = self.pos_rows[pair_idx]
        neg_slot = difficulty_to_index(difficulty, self.n_neg,
                                       self.use_max).to(self.device)
        neg_d = self.pools[pair_idx, neg_slot.long()]
        pos_ids, pos_mask = self.assemble(q, pos_d)
        neg_ids, neg_mask = self.assemble(q, neg_d)
        B = pair_idx.shape[0]
        denom = max(self.n_neg - 1, 1)
        return {
            "pos_ids": pos_ids,
            "pos_mask": pos_mask,
            "pos_labels": self.labels(B, True),
            "neg_ids": neg_ids,
            "neg_mask": neg_mask,
            "neg_labels": self.labels(B, False),
            "neg_rank": (neg_slot.float() / denom).expand(B),
        }

    def lce_batch(self, generator: torch.Generator, pair_idx: torch.Tensor,
                  difficulty, n: int):
        """LCE batch: n binomially-sampled negatives per pair, drawn with
        ``generator`` (reference LCEDataset.__getitem__ + collate). Negative
        prompts are (B*n, L) in example-major order."""
        B = pair_idx.shape[0]
        q = self.query_rows[pair_idx]
        pos_d = self.pos_rows[pair_idx]
        means = torch.as_tensor(difficulty, dtype=torch.float32,
                                device=self.device).expand(B)
        slots = sample_pool_indices_batch(generator, self.n_neg, means, n)
        neg_d = torch.gather(self.pools[pair_idx], 1, slots)  # (B, n)
        pos_ids, pos_mask = self.assemble(q, pos_d)
        neg_ids, neg_mask = self.assemble(q.repeat_interleave(n),
                                          neg_d.reshape(-1))
        return {
            "pos_ids": pos_ids,
            "pos_mask": pos_mask,
            "pos_labels": self.labels(B, True),
            "neg_ids": neg_ids,
            "neg_mask": neg_mask,
            "neg_labels": self.labels(B * n, False),
            "neg_rank": (slots.float() / max(self.n_neg - 1, 1)).reshape(-1),
        }
