"""Checkpoint / restart / elastic rescale: the V3 format of
``repro.train.checkpoint``, byte-compatible in both directions.

* **atomic**: the state is written to ``<dir>/tmp.<step>.*``, then renamed
  to ``<dir>/step_%08d``: a crash mid-write never corrupts the latest
  checkpoint;
* **exact restart**: restoring with the same node count gives the same
  state bit for bit (stacked replicas, optimizer state, channel state, step);
* **elastic rescale**: :func:`elastic_reshape` consensus-collapses the
  replicas and momentum and re-broadcasts them to a new node count.

Storage is one ``state.npz`` (keys are the tree paths joined by ``/``) and a
JSON manifest: ``format`` 3, ``step``, ``keys``, ``dtypes`` (every entry's
dtype by name), ``n_nodes``, and ``plane_tp`` / ``plane_model_axis`` /
``plane_rows`` when the run keeps its state in flat planes.  Dtypes numpy's
npz cannot carry — bfloat16 and the fp8 plane dtypes ``float8_e4m3fn`` and
``float8_e5m2`` — travel by their bits: a ``uint16`` or ``uint8`` view
stored as a ``V2`` or ``V1`` void, restored by the manifest's declared name
into the torch dtype.  No ``ml_dtypes`` is needed to write or read one.

A plane-form state (``state["planes"]`` holding the parameters, see
:mod:`repro_torch.train.train_state`) saves ``"params"`` as the tree of its
views, and not the planes: that is the layout ``repro``'s flat-plane state
has, whose step packs the parameters anew every step.  On resume
:func:`~repro_torch.train.train_state.reconcile_plane_state` rebuilds the
planes.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from ..utils import tree_leaves, tree_paths

Tree = Any

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "check_plane_manifest",
    "latest_step",
    "elastic_reshape",
]

# the dtypes stored as voids of their bits, and the integer view of each
_BITS = {torch.bfloat16: torch.uint16, torch.float8_e4m3fn: torch.uint8,
         torch.float8_e5m2: torch.uint8}
_BY_NAME = {str(dt).removeprefix("torch."): dt for dt in _BITS}


def _leaf_to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A state leaf -> ``(npz array, declared dtype name)``.  A Python int
    (the port's step counter) is stored as the reference's int32 scalar."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf, np.int32 if isinstance(leaf, int) else None)
        return a, a.dtype.name
    t = leaf.detach().cpu().contiguous()
    if t.dtype in _BITS:
        bits = t.view(_BITS[t.dtype]).numpy()
        return bits.view(np.dtype(f"V{bits.itemsize}")), str(t.dtype).removeprefix("torch.")
    a = t.numpy()
    return a, a.dtype.name


def _leaf_from_numpy(val: np.ndarray, name: str | None, key: str) -> torch.Tensor:
    """An npz array -> a CPU tensor of the declared dtype (``name``; None for
    a V2 manifest, where a 2-byte void can only be bfloat16)."""
    if name is None:
        name = "bfloat16" if val.dtype == np.dtype("V2") else val.dtype.name
    if name in _BY_NAME:
        want = _BY_NAME[name]
        bits = _BITS[want]
        if val.dtype.kind != "V" or val.dtype.itemsize != bits.itemsize:
            raise ValueError(f"{key}: declared {name}, stored {val.dtype}")
        ints = np.ascontiguousarray(val).view(np.uint16 if bits == torch.uint16 else np.uint8)
        return torch.from_numpy(ints.copy()).view(want)
    try:
        want_np = np.dtype(name)
    except TypeError:
        raise ValueError(
            f"checkpoint manifest declares unknown dtype {name!r} for {key} — the checkpoint "
            f"was written by an incompatible version"
        ) from None
    if val.dtype != want_np:
        raise ValueError(f"{key}: declared {name}, stored {val.dtype}")
    return torch.from_numpy(np.array(val, copy=True))


def _flatten(tree: Tree) -> dict[str, Any]:
    """``{path: leaf}``; empty subtrees vanish, as they do in the reference."""
    return dict(zip(tree_paths(tree), tree_leaves(tree)))


def save_checkpoint(directory: str, state: Tree, *, metadata: dict | None = None,
                    plane_layout=None) -> str:
    """Write one atomic checkpoint of ``state`` under ``directory``; returns
    its path.  ``plane_layout`` (the run's layout when it keeps its state in
    flat planes) stamps the manifest's plane fields."""
    step = int(state["step"])
    saved = {k: v for k, v in state.items() if k != "planes"}
    flat = _flatten(saved)
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"tmp.{step}.", dir=directory)
    try:
        arrays, dtypes = {}, {}
        for key, leaf in flat.items():
            arrays[key], dtypes[key] = _leaf_to_numpy(leaf)
        np.savez(os.path.join(tmp, "state.npz"), **arrays)
        params = state.get("params", {})
        manifest = {
            "format": 3,
            "step": step,
            "keys": sorted(arrays),
            "dtypes": dtypes,
            "n_nodes": int(params["embed"]["table"].shape[0]) if "embed" in params else None,
            **({"plane_tp": int(plane_layout.tp),
                "plane_model_axis": plane_layout.model_axis,
                "plane_rows": {k: int(v) for k, v in plane_layout.rows.items()}}
               if plane_layout is not None else {}),
            **(metadata or {}),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def check_plane_manifest(manifest: dict, stored_layout) -> None:
    """Fail fast when the manifest's ``plane_rows`` / ``plane_model_axis``
    disagree with the layout rebuilt from the current model config (the
    model changed between write and resume, so the stored planes cannot be
    read back).  Manifests without plane fields pass."""
    rows = manifest.get("plane_rows")
    if rows is not None:
        actual = {k: int(v) for k, v in stored_layout.rows.items()}
        declared = {k: int(v) for k, v in rows.items()}
        if declared != actual:
            raise ValueError(
                f"checkpoint manifest plane_rows {declared} do not match the layout rebuilt "
                f"from the current model config at tp={stored_layout.tp} ({actual}) — the "
                f"model config changed between checkpoint write and resume"
            )
    axis = manifest.get("plane_model_axis")
    if axis is not None and axis != stored_layout.model_axis:
        raise ValueError(f"checkpoint manifest plane_model_axis {axis!r} does not match the "
                         f"current layout's model axis {stored_layout.model_axis!r}")


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int | None = None) -> tuple[Tree, dict]:
    """``(state, manifest)`` of the checkpoint at ``step`` (default: the
    latest), with CPU tensors and ``state["step"]`` an int.  A V2 manifest
    (no ``"dtypes"``) restores a 2-byte void as bfloat16; a pre-channel
    checkpoint's ``"comp"`` bucket becomes ``channel["comp"]``."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes")
    state: Tree = {}
    with np.load(os.path.join(d, "state.npz")) as z:
        for key in z.files:
            leaf = _leaf_from_numpy(z[key], dtypes[key] if dtypes is not None else None, key)
            *parents, last = key.split("/")
            node = state
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = leaf
    state["step"] = int(state["step"])
    if "comp" in state:
        state["channel"] = {"comp": state.pop("comp")}
    state.setdefault("channel", {})  # empty subtrees are not stored
    return state, manifest


def elastic_reshape(state: Tree, new_n_nodes: int) -> Tree:
    """Consensus-collapse the stacked replicas and momentum (mean over the
    node axis in f32) and re-broadcast them to ``new_n_nodes``.  The channel
    state — residuals, delay rings, telemetry — is dropped: it is node-local,
    buffered payloads of the old cluster shape mean nothing on the new one,
    and :func:`~repro_torch.train.train_state.ensure_channel_state`
    re-initializes it to zeros (the reference's reset), from which the
    delayed channels re-warm with fresh gossip.  A plane-form state leaves
    as tree-form parameters, for ``reconcile_plane_state`` to re-plane."""

    def collapse(x):
        mean = torch.mean(x.to(torch.float32), dim=0, keepdim=True)
        return mean.expand((new_n_nodes,) + tuple(x.shape[1:])).to(x.dtype).contiguous()

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return collapse(tree)

    new = {k: v for k, v in state.items() if k != "planes"}
    new["params"] = walk(state["params"])
    new["opt"] = walk(state.get("opt", {}))
    new["channel"] = {}
    return new
