# -*- coding: utf-8 -*-
"""Latin syllabification (host-side, exact reference semantics).

Unit-based algorithm: isolate consonant groups and diphthongs with ``*``
markers, split the rest to characters, mark vowels, then iteratively stick
consonants to the following — then preceding — vowel seeds until every unit
contains a ``*`` marker. Reference: latinSyllabification.py:5-19 (tables),
:22-109 (syllabify_word), :170-174 (syllabify_text). The dead experimental
variants (latinSyllabification.py:112-167, :177-212) are intentionally not
reproduced.
"""

from __future__ import annotations

import functools

consonant_groups = [
    "qu", "ch", "ph", "fl", "fr", "st", "br", "cr", "cl", "pr", "tr", "ct", "th",
]
diphthongs = ["ae", "au", "ei", "oe", "ui", "ya", "ex", "ix"]
vowels = ["a", "e", "i", "o", "u", "y"]

# OCR abbreviation glyphs -> expanded syllables (latinSyllabification.py:9-19)
abbreviations = {
    "dns": ["do", "mi", "nus"],
    "dūs": ["do", "mi", "nus"],
    "dne": ["do", "mi", "ne"],
    "alla": ["al", "le", "lu", "ia"],
    "^": ["us"],
    "ā": ["am"],
    "ē": ["em"],
    "ū": ["um"],
    "ō": ["om"],
}


def syllabify_word(inp: str) -> list[str]:
    """Split a single Latin word into syllables (latinSyllabification.py:22-109).

    Memoized: chant transcripts repeat words heavily, and this runs per word
    per folio on the host (a pure function of the string). Returns a fresh
    list each call; the cached value is an immutable tuple."""
    return list(_syllabify_word_cached(inp))


@functools.lru_cache(maxsize=65536)
def _syllabify_word_cached(inp: str) -> tuple[str, ...]:
    return tuple(_syllabify_word_uncached(inp))


def _syllabify_word_uncached(inp: str) -> list[str]:
    if inp == "euouae":
        return "e-u-o-u-ae".split("-")
    if inp == "cuius":
        return "cu-ius".split("-")
    if inp == "eius":
        return "e-ius".split("-")

    word = [inp]

    # isolate consonant groups and diphthongs, marking each with '*'
    for unit in consonant_groups + diphthongs:
        new_word = []
        for segment in word:
            if "*" in segment:
                new_word.append(segment)
                continue

            split = segment.split(unit)
            rep_list = [unit + "*"] * len(split)
            interleaved = [val for pair in zip(split, rep_list) for val in pair]
            interleaved = [x for x in interleaved[:-1] if len(x) > 0]
            new_word += interleaved
        word = list(new_word)

    # split anything remaining into individual characters
    new_word = []
    for segment in word:
        if "*" in segment:
            new_word.append(segment.replace("*", ""))
            continue
        new_word += list(segment)
    word = list(new_word)

    # mark vowels and diphthongs as syllable seeds
    for i in range(len(word)):
        if word[i] in vowels + diphthongs:
            word[i] = word[i] + "*"

    # merge units: consonants stick first to the seed ahead, then behind.
    # A vowel-less token (e.g. an OCR fragment like "gl") has no seeds at
    # all — the reference's loop (latinSyllabification.py:71-107) never
    # terminates on such input; here it degrades to one opaque syllable.
    if not any(("*" in x) for x in word):
        return ["".join(word)] if word else []
    while not all(("*" in x) for x in word):
        new_word = []
        i = 0
        while i < len(word):
            if i + 1 >= len(word):
                new_word.append(word[i])
                break
            cur = word[i]
            proc = word[i + 1]
            if "*" in proc and "*" not in cur:
                new_word.append(cur + proc)
                i += 2
            else:
                new_word.append(cur)
                i += 1
        word = list(new_word)

        new_word = []
        i = 0
        while i < len(word):
            if i + 1 >= len(word):
                new_word.append(word[i])
                break
            cur = word[i]
            proc = word[i + 1]
            if "*" in cur and "*" not in proc:
                new_word.append(cur + proc)
                i += 2
            else:
                new_word.append(cur)
                i += 1
        word = list(new_word)

    word = [x.replace("*", "") for x in new_word]
    return word


def syllabify_text(text: str) -> list[str]:
    """Syllabify space-separated text, flattening per-word syllable lists
    (latinSyllabification.py:170-174)."""
    words = text.split(" ")
    word_syls = [syllabify_word(w) for w in words]
    return [item for sublist in word_syls for item in sublist]
