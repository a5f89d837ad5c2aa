"""Experiment logging facade (port of ``dilabhelmholtzoct_tpu/utils/logging.py``).

The reference's observability backbone is wandb (octsam/models/training.py:
173-180; training_utils.py:71-73,348,378). This facade preserves the metric
-name contract (``train/train_loss``, ``train/epoch``, ``val/valid_loss``,
``val/epoch``, ``{split}_samples``) while logging to stdout + JSONL by
default, with wandb as an optional backend when the package is installed —
training never takes a network dependency just to record a scalar.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class StdoutLogger:
    def log(self, data: dict[str, Any], step: int | None = None):
        def scalar(v):
            if isinstance(v, str):
                return v
            # try-float like JsonlLogger: numpy scalars and 0-d tensors are
            # not isinstance(int, float)
            try:
                return float(v)
            except (TypeError, ValueError):
                return "<obj>"

        scalars = {k: scalar(v) for k, v in data.items()}
        print(f"[log{'' if step is None else f' step={step}'}] "
              + json.dumps(scalars))

    def log_images(self, key: str, images: list):
        print(f"[log] {key}: {len(images)} image(s)")

    def finish(self):
        pass


class JsonlLogger:
    """Append-only JSONL metrics file — the durable record."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, data: dict[str, Any], step: int | None = None):
        rec = {"_time": time.time()}
        if step is not None:
            rec["_step"] = step
        for k, v in data.items():
            if isinstance(v, (int, float, str, bool)):
                rec[k] = v
            else:
                try:
                    rec[k] = float(v)
                except (TypeError, ValueError):
                    continue
        self._f.write(json.dumps(rec) + "\n")

    def log_images(self, key: str, images: list):
        self.log({key + "/count": len(images)})

    def finish(self):
        self._f.close()


class WandbLogger:
    """Optional wandb backend (parity with training.py:173-180)."""

    def __init__(self, project="dilabhelmholtzoct-tpu", entity=None,
                 name=None, config=None, dir=None):
        import wandb  # gated: not installed in this image

        self._wandb = wandb
        self.run = wandb.init(
            project=project, entity=entity, name=name, config=config,
            save_code=True, dir=dir,
        )

    def log(self, data, step=None):
        self._wandb.log(data, step=step)

    def log_images(self, key, images):
        self._wandb.log({key: images})

    def finish(self):
        self._wandb.finish()


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = [l for l in loggers if l is not None]

    def log(self, data, step=None):
        for l in self.loggers:
            l.log(data, step=step)

    def log_images(self, key, images):
        for l in self.loggers:
            l.log_images(key, images)

    def finish(self):
        for l in self.loggers:
            l.finish()


def make_logger(
    *,
    jsonl_path: str | None = None,
    use_wandb: bool = False,
    wandb_kwargs: dict | None = None,
    quiet: bool = False,
) -> MultiLogger:
    loggers = []
    if not quiet:
        loggers.append(StdoutLogger())
    if jsonl_path:
        loggers.append(JsonlLogger(jsonl_path))
    if use_wandb:
        try:
            loggers.append(WandbLogger(**(wandb_kwargs or {})))
        except ImportError:
            print("[log] wandb not installed; continuing without it")
        except Exception as e:  # init failure: no API key, no egress, ...
            # the facade's contract is that training never dies on the
            # logging backend — degrade exactly like the not-installed case
            print(f"[log] wandb.init failed ({e!r}); continuing without it")
    return MultiLogger(*loggers)
