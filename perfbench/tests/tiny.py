"""A benchmark of the same shape as the repository's, cut to a size the CPU
runs in seconds, for the tests: one root directory holding its own
``BENCHMARK.json``, configuration and limits beside a copy of the
harness's traffic, stage, metric and workload files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent.parent
REPO = PERFBENCH.parent


def tiny_spec(name: str, h: int = 48, w: int = 64) -> dict:
    spec = json.loads((PERFBENCH / "configs" / f"{name}.json").read_text())
    spec["image"] = {"height": h, "width": w}
    spec["data"]["frames"] = 12
    spec["scene"] = {"gaussians": 300 * (h * w) // (48 * 64),
                     "frames_generated": 14, "scale_range": [0.02, 0.06]}
    spec["map_gaussians"] = int(0.1 * h * w)
    spec["global_chunk"] = 6
    spec["train"]["first_frame_mapping_iters"] = 8
    return spec


def make_root(tmp: Path, limits: dict | None = None, h: int = 48,
              w: int = 64) -> tuple[Path, Path]:
    """(root, here): ``root`` holds BENCHMARK.json and the tiny
    configurations, ``here`` a copy of perfbench's data-driven files."""
    root = Path(tmp)
    here = root / "perfbench"
    for sub in ("traffic", "stages", "metrics", "workloads"):
        shutil.copytree(PERFBENCH / sub, here / sub)
    (here / "configs").mkdir(parents=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        (root / c["file"]).write_text(json.dumps(tiny_spec(c["name"], h, w)))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    if limits is not None:
        for cell in bench["workloads"]:
            (here / "workloads" / f"{cell['name']}.json").write_text(
                json.dumps({"limits": limits}))
    return root, here
