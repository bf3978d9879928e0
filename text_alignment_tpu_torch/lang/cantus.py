"""CANTUS CSV ingestion: per-folio chant transcripts.

Host-side, exact reference semantics (parse_cantus_csv.py:1-136):

- drop chants whose Mode column is ``*`` (no melody on page);
- group rows by folio (column 2), sort by on-page sequence (column 3);
- transcript text is the manuscript spelling (column 14) with ``j``s grafted
  from the standardized spelling (column 13), including the ``ihe -> ie``
  replacement;
- the returned lookup prepends the LAST chant of the PREVIOUS folio (chant
  text frequently spills across page turns);
- ``clean`` lowercases and strips to word characters + whitespace. The
  reference ran under Python 2 byte strings, where ``\\w`` is ASCII-only; we
  use ``re.ASCII`` so accented bytes are stripped identically.

Every quirk above is load-bearing for output parity and pinned by
tests/test_cantus.py.
"""

from __future__ import annotations

import csv
import re
from dataclasses import dataclass

# CANTUS export column layout (0-based; parse_cantus_csv.py reads these
# positions directly)
COL_FOLIO = 2
COL_SEQUENCE = 3
COL_MODE = 10
COL_STANDARD_SPELLING = 13
COL_MS_SPELLING = 14


@dataclass(frozen=True)
class ChantRow:
    """One chant incipit row of the CANTUS export."""

    folio: str
    sequence: int
    standard_spelling: str
    manuscript_spelling: str

    @property
    def text(self) -> str:
        return combine_transcripts(self.standard_spelling,
                                   self.manuscript_spelling)


@dataclass(frozen=True)
class FolioEntry:
    """One row of the optional seq <-> folio <-> image-filename mapping."""

    seq: int
    folio: str
    filename: str


def clean(text: str) -> str:
    """Regex cleanup: keep word chars/whitespace, collapse spaces, lowercase
    (parse_cantus_csv.py:5-13)."""
    text = re.sub(r"[^\s\w|]", "", text, flags=re.ASCII)
    text = re.sub(r" \| ", " ", text)
    text = re.sub(r" +", " ", text)
    return text.lower()


def combine_transcripts(standard: str, manuscript: str) -> str:
    """Graft ``j`` spellings from the standardized transcript onto the
    manuscript spelling (parse_cantus_csv.py:16-35): every j-carrying word
    of the standard text is turned into a pattern with ``\\w`` at the j
    positions and substituted back over the manuscript text."""
    manuscript = manuscript.replace("ihe", "ie")
    if not standard:
        return manuscript
    for match in re.finditer(r"\w*[jJ]\w*", standard):
        word = match.group().lower()
        manuscript = re.sub(word.replace("j", r"\w"), word, manuscript)
    return manuscript


def _read_chant_rows(transcript_path: str) -> list[ChantRow]:
    with open(transcript_path) as f:
        raw = list(csv.reader(f, delimiter=","))[1:]  # drop header
    rows = []
    for r in raw:
        # no melody on page (Mode '*') or stray repeated header: skip
        if r[COL_MODE] == "*" or r[COL_FOLIO] == "folio":
            continue
        rows.append(ChantRow(
            folio=r[COL_FOLIO],
            sequence=int(r[COL_SEQUENCE]),
            standard_spelling=r[COL_STANDARD_SPELLING],
            manuscript_spelling=r[COL_MS_SPELLING],
        ))
    return rows


def _read_mapping(mapping_path: str | None,
                  folio_names: list[str]) -> list[FolioEntry]:
    if not mapping_path:
        return [FolioEntry(seq=i, folio=name, filename=name)
                for i, name in enumerate(folio_names)]
    with open(mapping_path) as f:
        reader = csv.reader(f, delimiter=",")
        next(reader)  # header
        return [FolioEntry(seq=int(r[0]), folio=r[1], filename=r[2])
                for r in reader]


def _natural_folio_key(name: str):
    """Page-order sort key for folio names: split into digit / non-digit
    runs so '9r' < '10r' < '10v' < '100r' (lexicographic would put '10r'
    before '9r')."""
    parts = re.split(r"(\d+)", name)
    return [int(p) if p.isdigit() else p for p in parts]


def filename_to_text_func(transcript_path: str, mapping_path: str | None = None):
    """Return a lookup ``folio_to_text(seq_or_folio) -> (filename, text)``.

    Accepts an int sequence number or a str folio name; raises ``ValueError``
    for unknown or duplicated folios (parse_cantus_csv.py:38-128).
    """
    chant_rows = _read_chant_rows(transcript_path)
    folio_names = sorted({row.folio for row in chant_rows})
    mapping = _read_mapping(mapping_path, folio_names)

    chants_by_folio: dict[str, list[str]] = {}
    for name in folio_names:
        on_page = sorted((r for r in chant_rows if r.folio == name),
                         key=lambda r: r.sequence)
        chants_by_folio[name] = [r.text for r in on_page]

    def folio_to_text(key: int | str):
        if isinstance(key, int) and not isinstance(key, bool):
            hits = [(i, e) for i, e in enumerate(mapping) if e.seq == key]
        else:
            hits = [(i, e) for i, e in enumerate(mapping) if e.folio == key]
        if not hits:
            raise ValueError(f"folio / seq {key} not found")
        if len(hits) > 1:
            raise ValueError(f"duplicates found for {key}")

        idx, entry = hits[0]
        # chant text frequently spills across a page turn: start from the
        # previous folio's last chant (mapping[-1] wraps on the first folio,
        # matching the reference's idx-1 indexing)
        prev_folio = mapping[idx - 1].folio
        parts = []
        if prev_folio in chants_by_folio:
            parts.append(chants_by_folio[prev_folio][-1])
        else:
            parts.append("")
        # a page may carry only text continued from the previous page
        parts.extend(chants_by_folio.get(entry.folio, []))

        filename = entry.filename.replace("CF-", "")
        return filename, clean(" ".join(parts))

    # manuscript enumeration for callers (cli --folios all): every folio
    # the chant CSV names, in page order — the reference has no analog
    # (its __main__ blocks hardcode folio lists, alignToOCR.py:387-405).
    # NB: natural-sorted (numeric prefix, then recto/verso suffix) so
    # unpadded names enumerate '9r' before '10r'; the lexicographic
    # folio_names order above is kept for the mapping-less prev-folio
    # semantics, which mirror the reference's folio_names.sort()
    # (parse_cantus_csv.py:59-60).
    folio_to_text.folios = sorted(folio_names, key=_natural_folio_key)
    return folio_to_text
