"""Overlapped index refresh: the port of train/overlap.py.

On one device the online loop's refresh is dead time: the next step mines
from the new index, so training waits for the re-encode (train/online.py).
The JAX package splits the devices into a train submesh and an encode
submesh, whose programs share no device and run at the same time. Here the
encode has a device of its own, ``encode_device``:

- on a second card (``cuda:1``), the same split as the JAX package's;
- on one card, the training card itself, where the refresh runs on a CUDA
  stream of its own beside the training step's (the card's scheduler
  interleaves the two streams' kernels where they leave room);
- on the CPU, the training process's CPU.

The protocol is JAX's (overlap.py:15-40):

  1. ``start(params)`` at the trigger step: snapshot the params onto the
     encode device and hand the refresh to a host thread, which launches
     every slice's encode (about 1,536 fused-block launches at 16,384 docs
     at t5-base) so that neither the launches nor their host time hold up
     the training loop; on the CPU that thread computes;
  2. training goes on against the OLD index;
  3. ``collect()`` at a later chunk boundary: wait for the thread, order
     the caller's stream after the refresh's (an event, not a device-wide
     synchronise) and hand over the new index.

The refresh encodes with the params of the TRIGGER step, and the swap lands
``overlap_delay_chunks`` chunk boundaries later (OnlineMiningLoop), so the
steps in between mine from an index one refresh older than the serial
loop's: bounded, explicit staleness instead of the serial refresh's stall.

Hazards of a second stream, each handled below: the snapshot is a copy
(the optimizer returns new tensors, ``optim.apply_updates``, but a caller
may write its params in place), taken on the caller's stream and waited
for by the side stream through an event; every tensor allocated on one
stream and read on the other is ``record_stream``-ed, so that the caching
allocator does not hand its memory out again while the other stream may
still read it; the slices go into one buffer as ``make_refresh_fn``'s do,
so no second full index exists on the encode device.

Built inside a ``with mesh:`` block, a refresher encodes this rank's shard
of the docs only (the rows ``make_refresh_fn`` encodes under that mesh).
Its thread runs no collective: two threads issuing collectives on one
group can interleave and hang. So ``start`` takes whole weights; under
tensor parallelism the caller gathers them on its own thread
(``train.state.encoder_weights``, as OnlineMiningLoop does), and a split
weight reaching the thread raises there (it sees no mesh).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import threading

import torch

from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.dual_encoder import encode_corpus
from pacednegatives_tpu_torch.ops.mips import quantize_embeddings
from pacednegatives_tpu_torch.parallel.mesh import current_mesh, shard_range
from pacednegatives_tpu_torch.train.online import OnlineMiningConfig


def _indexed(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def split_devices(devices, n_encode: int):
    """(train_devices, encode_devices): the LAST ``n_encode`` devices
    encode (a contiguous tail, as the JAX package takes it)."""
    devices = list(devices)
    if not 0 < n_encode < len(devices):
        raise ValueError(
            f"n_encode must be in (0, {len(devices)}), got {n_encode}"
        )
    return devices[:-n_encode], devices[-n_encode:]


@dataclasses.dataclass
class OverlappedRefresher:
    """Index refresh on ``encode_device`` beside training (see the module
    docstring). Build once per run: the doc-token slices move to the
    encode device here (tokens are static; only params move a refresh).
    ``close()`` ends its thread."""

    corpus: DeviceCorpus
    model_cfg: t5.T5Config
    mining: OnlineMiningConfig
    # None: the corpus's device (on one card, a side stream of it)
    encode_device: torch.device | str | None = None

    def __post_init__(self):
        self._device = _indexed(self.encode_device or self.corpus.device)
        lo, hi = shard_range(self.corpus.d_tokens.shape[0], current_mesh())
        self._rows = hi - lo
        per = max(min(self._rows, self.mining.refresh_rows_per_call), 1)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        c = self.corpus
        self._slices = []  # (offset in the shard, rows, tokens, mask)
        for i in range(0, self._rows, per):
            size = min(i + per, self._rows) - i
            tok = c.d_tokens[lo + i:lo + i + size].to(self._device)
            mask = (None if c.d_mask is None
                    else c.d_mask[lo + i:lo + i + size].to(self._device))
            for t in (tok, mask):
                if t is not None and self._stream is not None:
                    t.record_stream(self._stream)
            self._slices.append((i, size, tok, mask))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="overlapped-refresh")
        self._pending = None  # (future, cancel event)

    @property
    def in_flight(self) -> bool:
        return self._pending is not None

    @property
    def launching(self) -> bool:
        """True while the refresh thread is still at work (on the card its
        launches may be done before the work they queued is)."""
        return self._pending is not None and not self._pending[0].done()

    def start(self, params) -> None:
        """Snapshot ``params`` (whole weights; see the module docstring)
        onto the encode device and hand every slice's encode to the
        refresh thread; returns without waiting for it. Call ``collect``
        later."""
        if self._pending is not None:
            raise RuntimeError("refresh already in flight — collect() first")
        snap = t5.tree_map(
            lambda p: p.detach().to(self._device, copy=True), params)
        ready = None
        if self._stream is not None:
            # the copy is ordered on the encode device's current stream
            # (a cross-device copy waits on both devices' current streams)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._device))
            for p in t5.flatten_params(snap).values():
                p.record_stream(self._stream)
        cancel = threading.Event()
        self._pending = (self._pool.submit(self._encode, snap, ready, cancel),
                         cancel)

    def _encode(self, params, ready, cancel):
        """The refresh thread: make_refresh_fn's slices, one buffer."""
        m, c = self.mining, self.corpus
        with contextlib.ExitStack() as scope:
            scope.enter_context(torch.no_grad())
            if self._stream is not None:
                scope.enter_context(torch.cuda.device(self._device))
                scope.enter_context(torch.cuda.stream(self._stream))
                self._stream.wait_event(ready)
            bufs = None
            for off, size, tok, mask in self._slices:
                if cancel.is_set():
                    return None
                emb = encode_corpus(params, self.model_cfg, tok, mask,
                                    batch_size=m.encode_batch,
                                    pad_id=c.pad_id)
                leaves = quantize_embeddings(emb) if m.quantize else (emb,)
                del emb
                if bufs is None:
                    bufs = tuple(x.new_empty((self._rows,) + x.shape[1:])
                                 for x in leaves)
                for buf, x in zip(bufs, leaves):
                    buf[off:off + size].copy_(x)
            done = None
            if self._stream is not None:
                done = torch.cuda.Event()
                done.record(self._stream)
        return bufs, done

    def discard(self) -> None:
        """Drop an in-flight refresh without assembling the index: the
        thread stops after the slice it is on, and its buffers are freed
        (at the end of a run, collect() would pay for an index no one
        reads)."""
        if self._pending is not None:
            self._pending[1].set()
            self._pending = None

    def collect(self, old=None):
        """The new index on the corpus's device: the (N, D) embeddings, or
        the (int8 values, scales) pair with ``mining.quantize``. Blocks
        only until the refresh is done. ``old`` (the previous index, same
        shapes) takes the new values in place when the encode device is
        another card, so that no second full index lands on this one."""
        if self._pending is None:
            raise RuntimeError("no refresh in flight")
        (future, _), self._pending = self._pending, None
        bufs, done = future.result()
        if done is not None:
            # the caller's streams wait for the side stream (an event, no
            # device-wide synchronise); the buffers were allocated on the
            # side stream and are read on the caller's from now on
            here = torch.cuda.current_stream(self._device)
            here.wait_event(done)
            for b in bufs:
                b.record_stream(here)
        target = _indexed(self.corpus.device)
        if self._device != target:
            olds = (() if old is None else
                    old if isinstance(old, tuple) else (old,))
            bufs = tuple(
                o.copy_(b) if o is not None and o.shape == b.shape
                and o.dtype == b.dtype else b.to(target)
                for b, o in zip(bufs, (*olds, *[None] * len(bufs))))
        return bufs if self.mining.quantize else bufs[0]

    def close(self) -> None:
        """Discard any refresh in flight and end the thread."""
        self.discard()
        self._pool.shutdown(wait=True)
