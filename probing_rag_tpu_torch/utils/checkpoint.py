"""Reader for the JAX package's pytree checkpoints (flat npz + manifest).

Port of ``load_pytree`` from ``probing_rag_tpu/utils/checkpoint.py``,
numpy only: ``save_pytree`` stores bf16 leaves as their ``uint16`` view and
names them in the manifest's ``exotic_dtypes``; they come back here as
``torch.bfloat16`` tensors through that view, without ``ml_dtypes``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch


def load_pytree(path: Path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a ``save_pytree`` checkpoint as a nested dict of CPU tensors
    rebuilt from the flattened key paths. Returns (tree, meta)."""
    path = Path(path)
    manifest = json.loads(path.with_suffix(".json").read_text())
    exotic = manifest.get("exotic_dtypes", {})
    nested: Dict[str, Any] = {}
    with np.load(path.with_suffix(".npz")) as arrays:
        for key in arrays.files:
            arr = arrays[key]
            if key in exotic:
                if exotic[key] != "bfloat16":
                    raise NotImplementedError(f"{key}: {exotic[key]} leaves are not supported")
                value = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                value = torch.from_numpy(np.ascontiguousarray(arr))
            parts = key.split("/")
            node = nested
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
    return nested, manifest["meta"]
