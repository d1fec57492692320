"""Export a TrainedTokenizer as a sentencepiece-format ``spiece.model``.

Closes the last reference-parity artifact gap (SURVEY §2.7): the reference
ships T5's sentencepiece model (``T5Tokenizer.from_pretrained``,
lceT5.py:106); this environment has no ``sentencepiece`` module, so the
exporter hand-encodes the PUBLIC sentencepiece ``ModelProto`` protobuf wire
format directly — no codegen, no runtime dependency. The emitted file is a
standard Unigram ModelProto that ``sentencepiece.SentencePieceProcessor``
and ``transformers.T5Tokenizer`` load on any machine that has them.

Wire format is plain protobuf: tag = (field_number << 3) | wire_type,
varints, and length-delimited submessages. Field numbers follow the public
``sentencepiece_model.proto`` schema:

  ModelProto:      pieces=1 (repeated), trainer_spec=2, normalizer_spec=3
  SentencePiece:   piece=1 (string), score=2 (float), type=3 (enum)
                   NORMAL=1 UNKNOWN=2 CONTROL=3 USER_DEFINED=4 BYTE=6
  TrainerSpec:     model_type=3 (UNIGRAM=1), vocab_size=4,
                   unk_id=40, bos_id=41, eos_id=42, pad_id=43
  NormalizerSpec:  name=1, add_dummy_prefix=3, remove_extra_whitespaces=4,
                   escape_whitespaces=5

A matching minimal reader (`read_model`) round-trips the file for tests.
"""

from __future__ import annotations

import json
import struct

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, BYTE = 1, 2, 3, 4, 6
_UNIGRAM = 1


# --- wire-format primitives -------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


# --- writer -----------------------------------------------------------------


def _piece(text: str, score: float, ptype: int) -> bytes:
    body = _len_field(1, text.encode("utf-8")) + _float_field(2, score)
    if ptype != NORMAL:  # NORMAL is the proto default; spm omits it
        body += _varint_field(3, ptype)
    return _len_field(1, body)


def build_model_bytes(
    vocab: list[tuple[str, float]],
    unk_id: int,
    pad_id: int | None = None,
    eos_id: int | None = None,
    bos_id: int | None = None,
    control: set[str] | None = None,
    user_defined: set[str] | None = None,
) -> bytes:
    """Serialize a Unigram ModelProto from (piece, log-prob score) rows."""
    control = control or set()
    user_defined = user_defined or set()
    out = bytearray()
    for i, (text, score) in enumerate(vocab):
        if i == unk_id:
            t = UNKNOWN
        elif text in control:
            t = CONTROL
        elif text in user_defined:
            t = USER_DEFINED
        else:
            t = NORMAL
        out += _piece(text, float(score), t)

    trainer = (
        _varint_field(3, _UNIGRAM)
        + _varint_field(4, len(vocab))
        + _varint_field(40, unk_id)
        + _varint_field(41, bos_id if bos_id is not None else (1 << 64) - 1)
        + _varint_field(42, eos_id if eos_id is not None else (1 << 64) - 1)
        + _varint_field(43, pad_id if pad_id is not None else (1 << 64) - 1)
    )
    out += _len_field(2, trainer)

    normalizer = (
        _len_field(1, b"identity")
        + _varint_field(3, 1)  # add_dummy_prefix (Metaspace-compatible)
        + _varint_field(4, 1)  # remove_extra_whitespaces
        + _varint_field(5, 1)  # escape_whitespaces -> U+2581 pieces
    )
    out += _len_field(3, normalizer)
    return bytes(out)


def export_sentencepiece(tok, path: str) -> None:
    """Write ``tok`` (TrainedTokenizer) as a sentencepiece Unigram model.

    Piece order preserves the tokenizer's ids, so token ids in checkpoints
    and stores remain valid under the exported artifact.
    """
    model = json.loads(tok._tok.to_str())["model"]
    if model["type"] != "Unigram":
        raise ValueError(f"only Unigram exports; got {model['type']}")
    vocab = [(p, s) for p, s in model["vocab"]]
    blob = build_model_bytes(
        vocab,
        unk_id=model["unk_id"],
        pad_id=tok.pad_id,
        eos_id=tok.eos_id,
        control={"<pad>", "</s>"},
        user_defined={"<true>", "<false>"},
    )
    with open(path, "wb") as f:
        f.write(blob)


# --- minimal reader (round-trip tests; mirrors the wire rules above) --------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def read_model(path: str) -> dict:
    """Parse pieces + trainer ids back out of a ModelProto file."""
    buf = open(path, "rb").read()
    pieces, trainer = [], {}
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            ln, i = _read_varint(buf, i)
            payload, i = buf[i : i + ln], i + ln
            if field == 1:  # SentencePiece
                j, text, score, ptype = 0, None, None, NORMAL
                while j < len(payload):
                    t2, j = _read_varint(payload, j)
                    f2, w2 = t2 >> 3, t2 & 7
                    if w2 == 2:
                        l2, j = _read_varint(payload, j)
                        if f2 == 1:
                            text = payload[j : j + l2].decode("utf-8")
                        j += l2
                    elif w2 == 5:
                        if f2 == 2:
                            (score,) = struct.unpack("<f", payload[j : j + 4])
                        j += 4
                    elif w2 == 0:
                        v2, j = _read_varint(payload, j)
                        if f2 == 3:
                            ptype = v2
                pieces.append((text, score, ptype))
            elif field == 2:  # TrainerSpec: just the id fields
                j = 0
                while j < len(payload):
                    t2, j = _read_varint(payload, j)
                    f2, w2 = t2 >> 3, t2 & 7
                    if w2 == 0:
                        v2, j = _read_varint(payload, j)
                        key = {3: "model_type", 4: "vocab_size", 40: "unk_id",
                               41: "bos_id", 42: "eos_id", 43: "pad_id"}.get(f2)
                        if key:
                            # ids use -1 (as uint64) for "disabled"
                            if key.endswith("_id") and v2 == (1 << 64) - 1:
                                v2 = -1
                            trainer[key] = v2
                    elif w2 == 2:
                        l2, j = _read_varint(payload, j)
                        j += l2
                    elif w2 == 5:
                        j += 4
        elif wire == 0:
            _, i = _read_varint(buf, i)
        elif wire == 5:
            i += 4
    return {"pieces": pieces, "trainer": trainer}
