"""Classic Porter (1980) stemmer — Python twin of native/src/porter.h.

Used by the pure-NumPy fallback index so stemmed retrieval behaves
identically with or without the native library; cross-validated against the
C++ implementation in tests/test_porter.py. Includes Porter's two published
amendments (step-2 ``bli``->``ble`` and ``logi``->``log``), matching
Terrier's PorterStemmer term pipeline (the reference retrieves against
``terrier_stemmed`` indexes — utilities/compute_all_bm25.py:26-27).
"""

from __future__ import annotations

_VOWELS = frozenset("aeiou")


def _vowel(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return True
    if c == "y":
        return i > 0 and not _vowel(w, i - 1)
    return False


def _measure(w: str, j: int) -> int:
    """m = number of VC sequences in w[0..j] inclusive."""
    n = 0
    i = 0
    while True:
        if i > j:
            return n
        if _vowel(w, i):
            break
        i += 1
    i += 1
    while True:
        while True:
            if i > j:
                return n
            if not _vowel(w, i):
                break
            i += 1
        i += 1
        n += 1
        while True:
            if i > j:
                return n
            if _vowel(w, i):
                break
            i += 1
        i += 1


def _has_vowel(w: str, j: int) -> bool:
    return any(_vowel(w, i) for i in range(j + 1))


def _dbl_cons(w: str, i: int) -> bool:
    return i >= 1 and w[i] == w[i - 1] and not _vowel(w, i)


def _cvc(w: str, i: int) -> bool:
    if i < 2 or _vowel(w, i) or not _vowel(w, i - 1) or _vowel(w, i - 2):
        return False
    return w[i] not in "wxy"


_STEP2 = (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
    ("anci", "ance"), ("izer", "ize"), ("bli", "ble"),
    ("alli", "al"), ("entli", "ent"), ("eli", "e"),
    ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
    ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
    ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
    ("iviti", "ive"), ("biliti", "ble"), ("logi", "log"),
)

_STEP3 = (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""),
)

_STEP4 = (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
)


def stem(w: str) -> str:
    if len(w) <= 2:
        return w

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    cleanup = False
    if w.endswith("eed"):
        if _measure(w, len(w) - 4) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w, len(w) - 3):
            w = w[:-2]
            cleanup = True
    elif w.endswith("ing"):
        if _has_vowel(w, len(w) - 4):
            w = w[:-3]
            cleanup = True
    if cleanup:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _dbl_cons(w, len(w) - 1):
            if w[-1] not in "lsz":
                w = w[:-1]
        elif _measure(w, len(w) - 1) == 1 and _cvc(w, len(w) - 1):
            w += "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w, len(w) - 2):
        w = w[:-1] + "i"

    # Step 2 (first string match decides, Porter switch semantics)
    for suf, rep in _STEP2:
        if w.endswith(suf):
            j = len(w) - len(suf) - 1
            if _measure(w, j) > 0:
                w = w[: j + 1] + rep
            break

    # Step 3
    for suf, rep in _STEP3:
        if w.endswith(suf):
            j = len(w) - len(suf) - 1
            if _measure(w, j) > 0:
                w = w[: j + 1] + rep
            break

    # Step 4
    for suf in _STEP4:
        if w.endswith(suf):
            j = len(w) - len(suf) - 1
            ok = _measure(w, j) > 1
            if ok and suf == "ion":
                ok = j >= 0 and w[j] in "st"
            if ok:
                w = w[: j + 1]
            break

    # Step 5a
    if w.endswith("e"):
        j = len(w) - 2
        a = _measure(w, j)
        if a > 1 or (a == 1 and not _cvc(w, j)):
            w = w[:-1]
    # Step 5b
    last = len(w) - 1
    if w and w[last] == "l" and _dbl_cons(w, last) and _measure(w, last) > 1:
        w = w[:-1]
    return w
