"""Metrics sinks: stdout logging, results.jsonl, TensorBoard/wandb (gated).

Reference: open_clip_train/logger.py (hostname-tagged formatter),
train.py:224-243 per-step scalar sinks behind --report-to, results.jsonl
appended per eval (train.py:342-344).
"""

from __future__ import annotations

import json
import logging
import os
import socket
from typing import Dict, Optional, Sequence


def setup_logging(level=logging.INFO, include_host: bool = False) -> None:
    if include_host:
        fmt = f"%(asctime)s | {socket.gethostname()} | %(levelname)s | %(message)s"
    else:
        fmt = "%(asctime)s | %(levelname)s | %(message)s"
    logging.basicConfig(level=level, format=fmt, datefmt="%Y-%m-%d,%H:%M:%S")


class MetricsLogger:
    """Fan-out scalar sink: log lines + results.jsonl + TB/wandb if available."""

    def __init__(
        self,
        log_dir: Optional[str] = None,
        report_to: Sequence[str] = (),
        run_name: str = "run",
    ):
        self.log_dir = log_dir
        self.jsonl_path = os.path.join(log_dir, "results.jsonl") if log_dir else None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        self._wandb = None
        if "tensorboard" in report_to and log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                logging.warning("tensorboard unavailable; skipping")
        if "wandb" in report_to:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="clip-embeds", name=run_name)
            except Exception:
                logging.warning("wandb unavailable; skipping")

    def log(self, metrics: Dict[str, float], step: int, prefix: str = "train") -> None:
        scalars = {f"{prefix}/{k}": float(v) for k, v in metrics.items()}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(dict(scalars, step=step))

    def log_eval(self, metrics: Dict[str, float], epoch: int) -> None:
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, **{
                    k: float(v) for k, v in metrics.items()
                }}) + "\n")
        self.log(metrics, epoch, prefix="val")
