"""JSONL metrics log and training panels (the ``MetricsLogger`` of
``freesurgs_tpu/utils/logging.py`` without its wandb and rich sinks): an
append-only ``metrics.jsonl`` any dashboard can tail, plain console lines,
and panels as PNGs under ``panels/``."""

from __future__ import annotations

import json
import os
import time
from typing import Any

from .image import save_image


class MetricsLogger:
    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, metrics: dict[str, Any], step: int | None = None,
            echo: bool = False):
        """Append one record: seconds since start, ``step`` if given, and
        the metrics (anything with ``__float__``, a tensor included, as a
        float)."""
        rec = {"t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = step
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if echo:
            self.info(" ".join(f"{k}={v}" for k, v in rec.items()))

    def log_image(self, name: str, img, step: int | None = None):
        """Save an (H, W, 3) float panel as
        ``<out_dir>/panels/<name>_<step:07d>.png`` (no suffix without a
        step)."""
        d = os.path.join(os.path.dirname(self.path), "panels")
        os.makedirs(d, exist_ok=True)
        suffix = f"_{step:07d}" if step is not None else ""
        save_image(img, os.path.join(d, f"{name}{suffix}.png"))

    def info(self, msg: str):
        print(msg, flush=True)

    def close(self):
        self._f.close()
