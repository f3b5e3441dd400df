"""JSONL metrics log (the ``MetricsLogger.log`` / ``info`` part of
``freesurgs_tpu/utils/logging.py``): an append-only ``metrics.jsonl`` any
dashboard can tail, and plain console lines."""

from __future__ import annotations

import json
import os
import time
from typing import Any


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

    def info(self, msg: str):
        print(msg, flush=True)

    def close(self):
        self._f.close()
