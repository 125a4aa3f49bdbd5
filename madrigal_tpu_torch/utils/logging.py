"""Logging / observability (a copy of `madrigal_tpu/utils/logging.py`,
which imports no JAX; the port keeps its own, logging under the
`madrigal_tpu_torch` logger).

Port of the reference's logging stack (reference: madrigal/utils.py:697-754
AverageMeter/ProgressMeter/get_root_logger; wandb usage throughout
pretrain.py / train_ddi_batch.py). wandb is optional: `MetricLogger` writes
JSONL locally and forwards to wandb when importable + configured, so
training runs are observable in any environment.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


def get_root_logger(fname: str = "out.log", file: bool = True
                    ) -> logging.Logger:
    logger = logging.getLogger("madrigal_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)-10s] %(message)s",
                            "%m/%d/%Y %H:%M:%S")
    if file:
        fh = logging.FileHandler(fname, mode="w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger


class AverageMeter:
    """Running value/average tracker (utils.py:700-721)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    def __init__(self, num_batches: int, meters, logger=None, prefix: str = ""):
        num_digits = len(str(num_batches))
        self.fmt = "[{:" + str(num_digits) + "d}/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix
        self.logger = logger

    def display(self, batch: int):
        entries = [self.prefix + self.fmt.format(batch)]
        entries += [str(m) for m in self.meters]
        msg = "\t".join(entries)
        (self.logger.info if self.logger else print)(msg)


class MetricLogger:
    """JSONL metric sink with optional wandb forwarding."""

    def __init__(self, out_dir: Optional[str] = None, run_name: str = "run",
                 use_wandb: bool = False, wandb_kwargs: Optional[dict] = None):
        self.out_path = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.out_path = os.path.join(out_dir, f"{run_name}_metrics.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        record = {"_time": time.time()}
        if step is not None:
            record["_step"] = step
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        if self.out_path:
            with open(self.out_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
