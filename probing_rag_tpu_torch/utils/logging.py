"""Structured logging: stdlib logger + JSONL run logs.

Port of ``get_logger``, ``JsonlWriter`` and ``wandb_log_adapter`` from
``probing_rag_tpu/utils/logging.py``: one record per training step or dev
evaluation, each a JSON line with a timestamp, and optionally the same
records to wandb. The loggers hang under the ``probing_rag_tpu_torch``
root.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

ROOT = "probing_rag_tpu_torch"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    root = logging.getLogger(ROOT)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return logger


class JsonlWriter:
    """Append-only JSONL record writer with automatic timestamps; a writer
    without a path drops its records."""

    def __init__(self, path: Optional[Path]):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, record: Dict[str, Any]) -> None:
        if not self.path:
            return
        record = {"ts": time.time(), **record}
        with self.path.open("a") as f:
            f.write(json.dumps(record, default=_jsonable) + "\n")


def _jsonable(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return str(x)


def wandb_log_adapter(project: str = "probing-rag-tpu",
                      **init_kwargs) -> Optional[Callable[[Dict[str, Any]], None]]:
    """Optional wandb hook for the prober training loop (the reference logs
    losses, lr and dev accuracy to wandb): a ``log(record)`` callable that
    flattens list values to ``key/i``, or None when wandb is not
    installed."""
    try:
        import wandb
    except ImportError:
        return None
    run = wandb.init(project=project, **init_kwargs)

    def log(record: Dict[str, Any]) -> None:
        flat = {}
        for key, value in record.items():
            if isinstance(value, list):
                for i, v in enumerate(value):
                    flat[f"{key}/{i}"] = v
            else:
                flat[key] = value
        run.log(flat)

    return log
