"""Plaintext transcript reading and OCR character cleanup.

Reference semantics: alignToOCR.py:61-87.
"""

from __future__ import annotations


def clean_special_chars(inp: str) -> str:
    """Remove special characters from OCR output (reference: alignToOCR.py:61-72)."""
    return inp.replace("~", "")


def read_file(fname: str) -> str:
    """Read a plaintext transcript of a manuscript page.

    Joins non-comment lines with spaces, strips newlines and "| " separators
    (reference: alignToOCR.py:75-87).
    """
    with open(fname, "r") as f:
        lines = f.readlines()
    lines = " ".join(x for x in lines if not x[0] == "#")
    lines = lines.replace("\n", "")
    lines = lines.replace("\r", "")
    lines = lines.replace("| ", "")
    return lines
