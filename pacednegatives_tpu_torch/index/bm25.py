"""Lexical retrieval: ctypes wrapper over the native C++ index, with a pure
NumPy fallback.

Replaces PISA (pool building, reference compute_all_bm25.py) and Terrier
(miner/teacher pipelines, mine_negatives.py:69-77) — see native/src/lexical.cpp.
The shared library auto-builds on first use (``make -C native``).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
from collections import Counter
from typing import Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "liblexical.so"))

MODEL_BM25 = 0
MODEL_DPH = 1
QE_NONE = 0
QE_BO1 = 1
QE_KL = 2
QE_RM3 = 3


def _make(force: bool = False) -> bool:
    cmd = ["make", "-C", os.path.abspath(_NATIVE_DIR)]
    if force:
        cmd.insert(1, "-B")
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return True
    except Exception:
        return False


def _load_lib():
    if not os.path.exists(_LIB_PATH) and not _make():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        _bind(lib)
    except OSError:
        return None
    except AttributeError:
        # A stale liblexical.so from an older commit lacks newer symbols
        # (e.g. lex_stem). Force a rebuild once and retry before giving up
        # to the NumPy fallback. dlopen caches by PATHNAME and ctypes never
        # dlcloses, so re-loading _LIB_PATH would return the stale
        # in-memory image — load the rebuilt file through a fresh temp
        # pathname instead (unlinked after load; the mapping persists).
        if not _make(force=True):
            return None
        import shutil
        import tempfile

        fresh = None
        try:
            fd, fresh = tempfile.mkstemp(suffix=".so", prefix="liblexical.")
            os.close(fd)
            shutil.copy2(_LIB_PATH, fresh)
            lib = ctypes.CDLL(fresh)
            _bind(lib)
        except (OSError, AttributeError):
            return None
        finally:
            # unlink even when copy/CDLL/bind raises — the dlopen mapping
            # (when it succeeded) persists without the directory entry
            if fresh is not None:
                try:
                    os.unlink(fresh)
                except OSError:
                    pass
    return lib


def _bind(lib) -> None:
    """Declare ctypes signatures; raises AttributeError on missing symbols."""
    lib.lex_create.argtypes = [ctypes.c_int]
    lib.lex_create.restype = ctypes.c_void_p
    lib.lex_stem.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.lex_stem.restype = ctypes.c_int
    lib.lex_free.argtypes = [ctypes.c_void_p]
    lib.lex_add_doc.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.lex_num_docs.argtypes = [ctypes.c_void_p]
    lib.lex_num_docs.restype = ctypes.c_int
    lib.lex_num_terms.argtypes = [ctypes.c_void_p]
    lib.lex_num_terms.restype = ctypes.c_int
    lib.lex_search.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
    ]
    lib.lex_search.restype = ctypes.c_int
    lib.lex_score_pair.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.lex_score_pair.restype = ctypes.c_double


_LIB = None
_LIB_TRIED = False


def _lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB = _load_lib()
        _LIB_TRIED = True
    return _LIB


_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


def native_stem(word: str) -> str | None:
    """Stem one token with the C++ Porter implementation (None if the
    native library is unavailable). Test/cross-validation hook."""
    lib = _lib()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(max(len(word) * 2, 64))
    lib.lex_stem(word.encode("utf-8", "ignore"), buf, len(buf))
    return buf.value.decode("utf-8")


class _PyIndex:
    """NumPy fallback: BM25 only, no query expansion."""

    def __init__(self, stem: bool = True):
        self.docs: list[Counter] = []
        self.df: Counter = Counter()
        self.doc_len: list[int] = []
        self.stem = stem

    def _toks(self, text: str) -> list[str]:
        toks = _tokenize(text)
        if self.stem:
            from pacednegatives_tpu_torch.index.porter import stem

            toks = [stem(t) for t in toks]
        return toks

    def add(self, text: str):
        tf = Counter(self._toks(text))
        self.docs.append(tf)
        self.doc_len.append(sum(tf.values()))
        for t in tf:
            self.df[t] += 1

    def search(self, query: str, k: int, k1: float, b: float):
        N = len(self.docs)
        avgdl = max(np.mean(self.doc_len), 1e-9) if self.doc_len else 1.0
        q = Counter(self._toks(query))
        scores = np.zeros(N)
        for t, qw in q.items():
            df = self.df.get(t, 0)
            if df == 0:
                continue
            idf = np.log((N - df + 0.5) / (df + 0.5) + 1.0)
            for d in range(N):
                tf = self.docs[d].get(t, 0)
                if tf:
                    denom = tf + k1 * (1 - b + b * self.doc_len[d] / avgdl)
                    scores[d] += qw * idf * tf * (k1 + 1) / denom
        cand = np.nonzero(scores)[0]
        order = cand[np.lexsort((cand, -scores[cand]))][:k]
        return order.astype(np.int32), scores[order]


class LexicalIndex:
    """BM25/DPH retrieval over an in-memory corpus.

    doc positions are row indices into the ``texts`` used to build it (align
    with TextCorpus.doc_ids).

    stem=True (default) applies classic Porter stemming to documents and
    queries — matching the reference's stemmed Terrier/PISA indexes
    (compute_all_bm25.py:26-27 ``terrier_stemmed``, eval.py:12).
    """

    def __init__(self, use_native: bool | None = None, stem: bool = True):
        lib = _lib() if use_native in (None, True) else None
        if use_native is True and lib is None:
            raise RuntimeError("native lexical library unavailable")
        self._lib = lib
        self._h = lib.lex_create(1 if stem else 0) if lib else None
        self._py = None if lib else _PyIndex(stem)
        self.stem = stem
        self.num_docs = 0

    @classmethod
    def build(
        cls,
        texts: Sequence[str],
        use_native: bool | None = None,
        stem: bool = True,
    ):
        ix = cls(use_native, stem=stem)
        for t in texts:
            ix.add_doc(t)
        return ix

    @property
    def native(self) -> bool:
        return self._lib is not None

    def add_doc(self, text: str) -> None:
        if self._lib:
            self._lib.lex_add_doc(self._h, text.encode("utf-8", "ignore"))
        else:
            self._py.add(text)
        self.num_docs += 1

    def search(
        self,
        query: str,
        k: int = 1000,
        model: int = MODEL_BM25,
        k1: float = 1.2,
        b: float = 0.75,
        qe: int = QE_NONE,
        # Terrier's query-expansion defaults (what the reference's
        # pt.rewrite.Bo1/KL/RM3 pipelines use): 3 feedback docs, 10 terms
        fb_docs: int = 3,
        fb_terms: int = 10,
        rm3_lambda: float = 0.6,
    ) -> tuple[np.ndarray, np.ndarray]:
        """-> (doc rows (n,), scores (n,)) best-first, n <= k."""
        if self._lib is None:
            if model != MODEL_BM25 or qe != QE_NONE:
                raise NotImplementedError(
                    "DPH/query-expansion need the native library"
                )
            return self._py.search(query, k, k1, b)
        ids = (ctypes.c_int32 * k)()
        scores = (ctypes.c_double * k)()
        n = self._lib.lex_search(
            self._h, query.encode("utf-8", "ignore"), k, model, k1, b,
            qe, fb_docs, fb_terms, rm3_lambda, ids, scores,
        )
        return (
            np.ctypeslib.as_array(ids)[:n].copy(),
            np.ctypeslib.as_array(scores)[:n].copy(),
        )

    def score_pair(
        self, query: str, doc_row: int, model: int = MODEL_BM25,
        k1: float = 1.2, b: float = 0.75,
    ) -> float:
        if self._lib is None:
            if model != MODEL_BM25:
                raise NotImplementedError(
                    "DPH scoring needs the native library"
                )
            ids, sc = self._py.search(query, self.num_docs, k1, b)
            pos = np.nonzero(ids == doc_row)[0]
            return float(sc[pos[0]]) if len(pos) else 0.0
        return float(
            self._lib.lex_score_pair(
                self._h, query.encode("utf-8", "ignore"), doc_row, model, k1, b
            )
        )

    def __del__(self):
        if getattr(self, "_lib", None) and getattr(self, "_h", None):
            self._lib.lex_free(self._h)
            self._h = None
