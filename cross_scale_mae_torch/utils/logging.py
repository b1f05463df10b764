"""Run directories and the ``log.jsonl`` record (counterpart of the part of
``cross_scale_mae_tpu/utils/logging.py`` the port runs: one process, no
TensorBoard or wandb, which the CLIs refuse)."""

from __future__ import annotations

import json
import os
from typing import Any, Optional


class RunLogger:
    """Appends one JSON object per epoch to ``<output_dir>/log.jsonl``
    (main_pretrain.py:631-634) and writes ``config.json`` when given one."""

    def __init__(self, output_dir: str, config: Optional[dict] = None):
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self._jsonl = open(os.path.join(output_dir, "log.jsonl"), "a")
        if config:
            with open(os.path.join(output_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log_epoch(self, payload: dict[str, Any]) -> None:
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


def auto_output_dir(base: str, **config: Any) -> str:
    """``base/<k_v-k_v...>`` from the config, with a ``+N`` suffix when that
    directory exists already (main_pretrain.py:450-493); created here."""
    name = "-".join(f"{k}_{v}" for k, v in config.items() if v is not None) or "run"
    path = os.path.join(base, name)
    if os.path.exists(path):
        i = 1
        while os.path.exists(f"{path}+{i}"):
            i += 1
        path = f"{path}+{i}"
    os.makedirs(path, exist_ok=True)
    return path
