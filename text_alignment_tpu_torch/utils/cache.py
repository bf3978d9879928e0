"""Content-addressed stage caches — the checkpoint/resume story.

The reference memoized expensive stages with ad-hoc pickles keyed by
filename (OCR results at pik/{fname}_boxes.pickle, alignToOCR.py:225-233,
:435-436; a commented-out preproc pickle, :207-215). Here the same idea is a
first-class utility: stage outputs are pickled under a key derived from the
*content* of the stage inputs (hashes of arrays/strings/params), so stale
caches are impossible by construction.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any

import numpy as np


def content_key(*parts: Any) -> str:
    """Stable hash of heterogeneous stage inputs."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(str(p.shape).encode())
            h.update(str(p.dtype).encode())
            h.update(np.ascontiguousarray(p).tobytes())
        elif isinstance(p, (bytes, bytearray)):
            h.update(p)
        else:
            h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:32]


class StageCache:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, stage: str, key: str) -> str:
        return os.path.join(self.root, f"{stage}_{key}.pickle")

    def get(self, stage: str, key: str):
        path = self._path(stage, key)
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except (OSError, pickle.UnpicklingError, AttributeError, EOFError):
            return None

    def put(self, stage: str, key: str, value) -> None:
        path = self._path(stage, key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f, -1)
        os.replace(tmp, path)

    def cached(self, stage: str, key: str, compute):
        hit = self.get(stage, key)
        if hit is not None:
            return hit
        value = compute()
        self.put(stage, key, value)
        return value
