"""Reference-compatible OCR cache loading.

A reference user migrating to this framework brings their
``pik/{fname}_boxes.pickle`` stage caches — Python-2 protocol-2 pickles of
``alignToOCR.CharBox`` instances (written at reference alignToOCR.py:435-436
via ``pickle.dump(all_chars, f, -1)``; consumed again at
evaluate_text_alignment.py:159-164). A plain py3 ``pickle.load`` fails on
them twice over: the ``alignToOCR`` module does not exist here
(ModuleNotFoundError), and Python-2 ``str`` payloads need latin1 decoding.

``load_charboxes`` is the one entry point for every ``existing_ocr_pickle``
surface (process / serve / evaluate CLI): any module's ``CharBox`` global is
remapped onto an attribute-bag shim, py2 strings decode latin1 (the numpy
py2-pickle convention), and each record is rebuilt through THIS framework's
``CharBox`` constructor — so derived attributes (``ulx``/``width``/…) exist
even for records the reference pickled in its "empty" state, where its
``__init__`` leaves the derived slots unset (alignToOCR.py:39-44).
"""

from __future__ import annotations

import pickle

from ..charbox import CharBox


class _CharBoxShim:
    """Attribute bag the unpickler BUILDs slot-state onto; rebuilt into a
    real CharBox afterwards."""


class _RefUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "CharBox":
            # reference streams say 'alignToOCR' (or '__main__' for ad-hoc
            # dumps); our own py3 streams say 'text_alignment_tpu.charbox'.
            # All rebuild through the same shim -> constructor path.
            return _CharBoxShim
        return super().find_class(module, name)


def load_charboxes(fileobj) -> list[CharBox]:
    """Load an OCR CharBox list pickled by this framework OR by the
    Python-2 reference. Raises the underlying pickle errors unchanged (the
    callers' reference-parity IOError/AttributeError fallbacks rely on
    that, alignToOCR.py:225-233)."""
    items = _RefUnpickler(fileobj, encoding="latin1").load()
    out = []
    for b in items:
        char = b.char
        if isinstance(char, bytes):  # py2 plain-str char payload
            char = char.decode("latin1")
        out.append(
            CharBox(char, getattr(b, "ul", None), getattr(b, "lr", None))
        )
    return out
