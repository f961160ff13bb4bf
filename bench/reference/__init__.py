"""The plain references, found by name.

``bench/reference/<family>.py`` is a model family's loss (the
configuration's ``run.family``); ``bench/reference/<algorithm>.py`` a
trainer (the traffic's ``trainer.algorithm``); ``topology/<name>.py`` a
mixing matrix and ``compression/<name>.py`` a gossip compressor.  A name
with no file is refused: the reference does not implement it.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
_LOADED: dict[Path, object] = {}


def load(kind: str, name: str):
    """The module ``bench/reference/[<kind>/]<name>.py`` (``kind`` one of
    ``family``, ``algorithm``, ``topology``, ``compression``)."""
    sub = {"family": "", "algorithm": "", "topology": "topology",
           "compression": "compression"}[kind]
    path = HERE / sub / f"{name}.py"
    if not name or "/" in name or not path.is_file():
        raise ValueError(f"the reference implements no {kind} {name!r} (no {path})")
    if path not in _LOADED:
        mod_name = "bench.reference." + ".".join(p for p in (sub, name) if p)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
