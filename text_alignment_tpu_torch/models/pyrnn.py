"""Loader/saver for ``.pyrnn.gz`` recognizer checkpoints.

The reference ships OCRopus models as gzipped Python-2 pickles of
``ocrolib.lstm.SeqRecognizer`` objects (alignToOCR.py:27-31, README.md:11;
the bundled salzinnes/stgall2 checkpoints are stripped from this mount,
.MISSING_LARGE_BLOBS:1-2). This loader reads that container format without
ocrolib: a permissive Unpickler maps any ocrolib/lstm/lineest class to an
attribute-bag stub (latin1 decoding for py2 numpy payloads), then the object
graph is walked structurally to extract

- the forward/backward LSTM weight sets (WGI/WGF/WGO/WCI/WIP/WFP/WOP),
- the softmax W2,
- the codec charset,
- the normalizer target height.

``save_pyrnn`` writes our trained models in the same shape (via synthetic
``ocrolib.lstm`` stub modules), so checkpoints stay interchangeable with the
reference's iteration-stamped ``*-NNNNNNNN.pyrnn.gz`` convention
(SURVEY.md §3.5).
"""

from __future__ import annotations

import gzip
import io
import pickle
import sys
import types

import numpy as np

from .codec import Codec
from .lineest_host import DEFAULT_TARGET_HEIGHT

_LSTM_KEYS = ("WGI", "WGF", "WGO", "WCI", "WIP", "WFP", "WOP")
_STUB_MODULES = ("ocrolib", "lstm", "lineest", "common")


class _Stub:
    def __init__(self, *args, **kwargs):
        self._init_args = args
        self._init_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _PermissiveUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in _STUB_MODULES or "ocrolib" in module:
            return type(name, (_Stub,), {"__module__": module})
        return super().find_class(module, name)


def _iter_objects(obj, seen=None):
    """Walk an unpickled object graph (stubs, lists, dicts)."""
    if seen is None:
        seen = set()
    if id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    if isinstance(obj, _Stub):
        for v in obj.__dict__.values():
            yield from _iter_objects(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _iter_objects(v, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _iter_objects(v, seen)


def _is_lstm(o):
    return isinstance(o, _Stub) and all(k in o.__dict__ for k in _LSTM_KEYS)


def _type_name(o):
    return type(o).__name__


def load_pyrnn(path: str):
    """Load a .pyrnn(.gz) checkpoint. Returns (params dict with
    'fwd'/'bwd'/'W2', Codec, target_height)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    obj = _PermissiveUnpickler(io.BytesIO(data), encoding="latin1").load()

    lstms = []
    W2 = None
    codec = None
    target_height = DEFAULT_TARGET_HEIGHT

    for o in _iter_objects(obj):
        if _is_lstm(o):
            lstms.append(o)
        elif isinstance(o, _Stub) and "W2" in o.__dict__:
            W2 = np.asarray(o.W2, dtype=np.float32)
        elif isinstance(o, _Stub) and _type_name(o) == "Codec":
            d = o.__dict__
            if "code2char" in d:
                c2c = d["code2char"]
                charset = [c2c[i] for i in sorted(c2c.keys())]
            else:
                charset = list(d.get("charset", []))
            codec = Codec([str(c) for c in charset])
        elif isinstance(o, _Stub) and "target_height" in o.__dict__:
            target_height = int(o.target_height)

    # a Reversed wrapper marks the backward direction; find which LSTM is
    # wrapped (its stub is reachable from a Reversed stub)
    reversed_children = set()
    for o in _iter_objects(obj):
        if isinstance(o, _Stub) and _type_name(o) == "Reversed":
            for c in _iter_objects(o):
                if _is_lstm(c):
                    reversed_children.add(id(c))

    if len(lstms) != 2 or W2 is None:
        raise ValueError(
            f"unrecognized pyrnn structure in {path}: "
            f"{len(lstms)} LSTM blocks, W2 {'missing' if W2 is None else 'ok'}"
        )

    if id(lstms[1]) in reversed_children and id(lstms[0]) not in reversed_children:
        fwd_o, bwd_o = lstms
    elif id(lstms[0]) in reversed_children and id(lstms[1]) not in reversed_children:
        bwd_o, fwd_o = lstms
    else:
        fwd_o, bwd_o = lstms  # ambiguous; keep graph order

    def conv(o):
        return {k: np.asarray(getattr(o, k), dtype=np.float32) for k in _LSTM_KEYS}

    params = {"fwd": conv(fwd_o), "bwd": conv(bwd_o), "W2": W2}
    if codec is None:
        nout = W2.shape[0]
        codec = Codec(["", "~"] + ["?"] * (nout - 2))
    return params, codec, target_height


def _fake_module(name):
    mod = sys.modules.get(name)
    if mod is None:
        mod = types.ModuleType(name)
        sys.modules[name] = mod
        if "." in name:  # register on parent so pickle's import checks pass
            parent_name, child = name.rsplit(".", 1)
            parent = _fake_module(parent_name)
            setattr(parent, child, mod)
    return mod


def _fake_class(module_name, cls_name):
    mod = _fake_module(module_name)
    cls = getattr(mod, cls_name, None)
    if cls is None:
        cls = type(cls_name, (_Stub,), {"__module__": module_name})
        setattr(mod, cls_name, cls)
    return cls


def save_pyrnn(path: str, params, codec: Codec,
               target_height: int = DEFAULT_TARGET_HEIGHT):
    """Write a checkpoint in the ocrolib SeqRecognizer shape (gzip pickle)."""
    LSTM = _fake_class("ocrolib.lstm", "LSTM")
    Reversed = _fake_class("ocrolib.lstm", "Reversed")
    Parallel = _fake_class("ocrolib.lstm", "Parallel")
    Softmax = _fake_class("ocrolib.lstm", "Softmax")
    Stacked = _fake_class("ocrolib.lstm", "Stacked")
    CodecC = _fake_class("ocrolib.lstm", "Codec")
    SeqRecognizer = _fake_class("ocrolib.lstm", "SeqRecognizer")
    CenterNormalizer = _fake_class("ocrolib.lineest", "CenterNormalizer")

    def mk(cls, **attrs):
        o = cls.__new__(cls)
        o.__dict__.update(attrs)
        return o

    def mk_lstm(W):
        d = {k: np.asarray(W[k], np.float32) for k in _LSTM_KEYS}
        ns, na = d["WGI"].shape
        return mk(LSTM, ns=ns, na=na, ni=na - ns - 1, **d)

    fwd = mk_lstm(params["fwd"])
    bwd = mk_lstm(params["bwd"])
    rev = mk(Reversed, net=bwd)
    par = mk(Parallel, nets=[fwd, rev])
    soft = mk(Softmax, W2=np.asarray(params["W2"], np.float32))
    stack = mk(Stacked, nets=[par, soft])
    cod = mk(
        CodecC,
        code2char={i: c for i, c in enumerate(codec.charset)},
        char2code={c: i for i, c in enumerate(codec.charset)},
    )
    lnorm = mk(CenterNormalizer, target_height=target_height)
    rec = mk(
        SeqRecognizer,
        lstm=stack,
        codec=cod,
        lnorm=lnorm,
        Ni=target_height,
        No=len(codec.charset),
    )

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        pickle.dump(rec, f, protocol=2)
