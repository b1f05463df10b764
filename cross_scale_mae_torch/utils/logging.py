"""Run logging: rank-0 printing, the ``log.jsonl`` record, TensorBoard and
wandb (counterpart of ``cross_scale_mae_tpu/utils/logging.py``).

The reference's channels (SURVEY.md §5): rank-0 print
(``util/misc.py:217-231``), TensorBoard scalars on the epoch_1000x axis
(``engine_pretrain.py:80-86``), wandb (``main_pretrain.py:496-548``) and
``log.jsonl`` (``main_pretrain.py:631-634``), behind one :class:`RunLogger`
with the JAX package's surface. TensorBoard and wandb engage only where
they import; otherwise the logger prints the JAX package's "unavailable;
skipping" line and logs on without them. Under data parallelism only rank
0 prints, logs and writes files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

from cross_scale_mae_torch.parallel.dist import is_main_process

WANDB_PROJECT = "cross_scale_mae_tpu"   # the JAX CLIs' --wandb_project default


def rank0_print(*args: Any) -> None:
    """print, flushed, on rank 0 (or the single process) alone."""
    if is_main_process():
        print(*args, flush=True)


def epoch_1000x(epoch_fractional: float) -> int:
    """The reference's TensorBoard x axis (engine_pretrain.py:82-86)."""
    return int(epoch_fractional * 1000)


@dataclasses.dataclass(frozen=True)
class LogOptions:
    """The CLIs' TensorBoard and wandb flags, as :class:`RunLogger` takes them."""

    use_tensorboard: bool = False
    use_wandb: bool = False
    wandb_project: str = WANDB_PROJECT
    wandb_entity: Optional[str] = None
    wandb_id: Optional[str] = None

    @classmethod
    def from_args(cls, args) -> "LogOptions":
        return cls(bool(args.use_tensorboard), bool(args.use_wandb),
                   args.wandb_project or WANDB_PROJECT, args.wandb_entity, args.wandb_id)


class RunLogger:
    """``log.jsonl`` (one JSON object per :meth:`log_epoch`) and
    ``config.json`` under ``output_dir``; with ``use_tensorboard`` a
    ``torch.utils.tensorboard.SummaryWriter`` under ``<output_dir>/tb``;
    with ``use_wandb`` a ``wandb.init`` run, resumed (``resume="allow"``)
    when ``wandb_id`` names one (main_pretrain.py:510-530). Rank 0 alone
    does any of it; the other ranks' loggers do nothing."""

    def __init__(self, output_dir: Optional[str], use_tensorboard: bool = False,
                 use_wandb: bool = False, wandb_project: str = WANDB_PROJECT,
                 run_name: Optional[str] = None, config: Optional[dict] = None,
                 wandb_entity: Optional[str] = None, wandb_id: Optional[str] = None):
        self.is_main = is_main_process()
        self.output_dir = output_dir
        self._jsonl = self._tb = self._wandb = None
        if not self.is_main:
            return
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(output_dir, "log.jsonl"), "a")
            if config:
                with open(os.path.join(output_dir, "config.json"), "w") as f:
                    json.dump(config, f, indent=2, default=str)
        if use_tensorboard and output_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(output_dir, "tb"))
            except ImportError:
                rank0_print("tensorboard unavailable; skipping TB logging")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project, entity=wandb_entity, name=run_name,
                           config=config or {}, id=wandb_id,
                           resume="allow" if wandb_id else None)
            except ImportError:
                rank0_print("wandb unavailable; skipping wandb logging")

    @classmethod
    def from_options(cls, output_dir: Optional[str], options: LogOptions,
                     run_name: Optional[str] = None, config: Optional[dict] = None
                     ) -> "RunLogger":
        return cls(output_dir, options.use_tensorboard, options.use_wandb,
                   options.wandb_project, run_name, config, options.wandb_entity,
                   options.wandb_id)

    @property
    def tensorboard_dir(self) -> Optional[str]:
        """The SummaryWriter's directory, None when TensorBoard is off."""
        return self._tb.log_dir if self._tb is not None else None

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def log_step(self, step_1000x: int, metrics: dict[str, Any]) -> None:
        """Each metric as a TensorBoard scalar at ``step_1000x``, and one
        wandb record of them all with ``step_1000x``."""
        if not self.is_main:
            return
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step_1000x)
        if self._wandb is not None:
            self._wandb.log({**{k: float(v) for k, v in metrics.items()},
                             "step_1000x": step_1000x})

    def log_epoch(self, payload: dict[str, Any]) -> None:
        """Append one epoch record to log.jsonl (main_pretrain.py:631-634)."""
        if not self.is_main or self._jsonl is None:
            return
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


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
