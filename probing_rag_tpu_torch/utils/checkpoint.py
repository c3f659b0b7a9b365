"""Pytree checkpoints in the JAX package's format: one npz + a JSON manifest.

Port of ``save_pytree`` and ``load_pytree`` from
``probing_rag_tpu/utils/checkpoint.py``, numpy only. A tree is a nested
dict of tensors (or arrays); each leaf is stored under its dict path joined
by ``/``. bf16 leaves are stored as their ``uint16`` view and named in the
manifest's ``exotic_dtypes`` (the JAX writer's rule for ml_dtypes leaves),
so either package reads the other's checkpoints. The manifest's
``treedef`` is a plain description of the nesting; no reader parses it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], dict):
            flat.update(_flatten(tree[key], path))
        else:
            flat[path] = tree[key]
    return flat


def _describe(tree) -> str:
    """The nesting with each leaf as ``*``, e.g. ``{'fc1': {'b': *, 'w': *}}``."""
    if not isinstance(tree, dict):
        return "*"
    return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"


def _stored(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """(array to store, exotic dtype name or None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        raise TypeError(f"numpy leaf of dtype {arr.dtype}: pass it as a torch tensor")
    return arr, None


def save_pytree(path: Path, tree, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``tree`` to ``path.npz`` and its manifest to ``path.json``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    exotic: Dict[str, str] = {}
    stored = {}
    for key, leaf in flat.items():
        stored[key], name = _stored(leaf)
        if name:
            exotic[key] = name
    np.savez(path.with_suffix(".npz"), **stored)
    manifest = {
        "meta": meta or {},
        "treedef": _describe(tree),
        "keys": sorted(flat),
        "exotic_dtypes": exotic,
    }
    path.with_suffix(".json").write_text(json.dumps(manifest, indent=2))


def load_pytree(path: Path, like=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a ``save_pytree`` checkpoint as a nested dict of CPU tensors.
    With ``like`` (a template tree), its leaf paths must be exactly the
    checkpoint's and the result has the template's nesting; otherwise the
    nesting is rebuilt from the key paths. Returns (tree, meta)."""
    path = Path(path)
    manifest = json.loads(path.with_suffix(".json").read_text())
    exotic = manifest.get("exotic_dtypes", {})
    flat: Dict[str, torch.Tensor] = {}
    with np.load(path.with_suffix(".npz")) as arrays:
        for key in arrays.files:
            arr = arrays[key]
            if key in exotic:
                if exotic[key] != "bfloat16":
                    raise NotImplementedError(f"{key}: {exotic[key]} leaves are not supported")
                flat[key] = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                flat[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if like is not None:
        template = _flatten(like)
        if set(template) != set(flat):
            raise ValueError(f"checkpoint keys mismatch: {set(template) ^ set(flat)}")

        def rebuild(node, prefix):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k)) if isinstance(v, dict)
                    else flat[f"{prefix}/{k}" if prefix else str(k)] for k, v in node.items()}

        return rebuild(like, ""), manifest["meta"]
    nested: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = nested
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return nested, manifest["meta"]
