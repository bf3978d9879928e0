"""Scoring-system resolution for affine-gap Needleman–Wunsch.

Accepted forms (reference: textSeqCompare.py:13-42):

- ``[match_func(a, b), gap_open_x, gap_open_y, gap_extend_x, gap_extend_y]``
- ``[match, mismatch, gap_open_x, gap_open_y, gap_extend_x, gap_extend_y]``
- ``[match, mismatch, gap_open, gap_extend]``

Default: ``[8, -4, -7, -7, -3, 0]`` (textSeqCompare.py:10).

Boundary rows of the DP matrices use the module-level constant
``BOUNDARY_GAP_EXTEND = -1`` regardless of the scoring system — a reference
quirk preserved for parity (textSeqCompare.py:9, :53-60). ``strict=False``
fixes it: the row-0 boundary (a leading run of unmatched OCR, the
horizontal/goy direction of the body recurrences) extends at
``gap_extend_y`` and the col-0 boundary (leading unmatched transcript,
vertical/gox direction) at ``gap_extend_x``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

DEFAULT_SYS = [8, -4, -7, -7, -3, 0]
BOUNDARY_GAP_EXTEND = -1


@dataclass
class Scoring:
    score: Callable  # score(a, b) -> number
    gap_open_x: float
    gap_open_y: float
    gap_extend_x: float
    gap_extend_y: float
    # (match, mismatch) when the score function is the default equality test;
    # None for custom callables. Lets device backends skip building a full
    # substitution matrix.
    match_mismatch: Optional[tuple] = None
    # boundary-row gap extends: the parity default is the reference's
    # stale module global (-1) on both axes; strict=False substitutes the
    # scoring system's own extends (see module docstring)
    bge_row0: float = BOUNDARY_GAP_EXTEND  # × j along row 0
    bge_col0: float = BOUNDARY_GAP_EXTEND  # × i along col 0


def resolve_scoring(scoring_system: Optional[Sequence],
                    strict: bool = True) -> Scoring:
    if scoring_system is None:
        scoring_system = DEFAULT_SYS

    if len(scoring_system) == 5 and callable(scoring_system[0]):
        scoring_method = scoring_system[0]
        gox, goy, gex, gey = scoring_system[-4:]
        sc = Scoring(scoring_method, gox, goy, gex, gey, None)
    elif len(scoring_system) == 6:
        match, mismatch = scoring_system[0], scoring_system[1]

        def default_score_method(a, b):
            return match if a == b else mismatch

        gox, goy, gex, gey = scoring_system[-4:]
        sc = Scoring(default_score_method, gox, goy, gex, gey,
                     (match, mismatch))
    elif len(scoring_system) == 4:
        match, mismatch = scoring_system[0], scoring_system[1]

        def default_score_method(a, b):
            return match if a == b else mismatch

        gox = goy = scoring_system[2]
        gex = gey = scoring_system[3]
        sc = Scoring(default_score_method, gox, goy, gex, gey,
                     (match, mismatch))
    else:
        raise ValueError("scoring_system {} invalid".format(scoring_system))

    if not strict:
        sc.bge_row0 = sc.gap_extend_y
        sc.bge_col0 = sc.gap_extend_x
    return sc
