"""Run one benchmark cell once and print its result line.

  python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Everything the run needs is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``perfbench/configs/``) and
traffic (``perfbench/traffic/<traffic>.json``, which names its stage
driver, ``perfbench/stages/<stage>.py``); ``perfbench/workloads/<cell>.json``
holds the limits of the numbers that decide ``correct``; each per-layer
metric is read by ``perfbench/metrics/<metric>.py``. With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones. The last lines on standard error, and the line's last key,
are the compared numbers beside their limits.

The run needs the CUDA card the cell asks for (it exits 2 without
printing a result otherwise); a one-card run keeps to two CPUs (``pin``) and never loads JAX or the JAX package: it
exits 3 if one of them is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "freesurgs_tpu")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    """Whether a metric is reported in ``cell``: an entry without a
    ``workloads`` list is reported in every cell."""
    return "workloads" not in entry or cell in entry["workloads"]


def pin(n: int = 2):
    """Keep this process, and what it starts, on ``n`` of the CPUs it may
    use (the third onwards, where there are enough): the host thread that
    dispatches every kernel keeps its core and caches."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 2 + n:
        os.sched_setaffinity(0, cpus[2:2 + n])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_label() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def load_cell(name: str, root: Path = ROOT, here: Path = HERE):
    """(benchmark, cell entry, configuration, traffic, limits) of a cell,
    each found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = {c["name"]: c for c in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    spec = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (here / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((here / "workloads" / f"{name}.json").read_text()
                        )["limits"]
    return bench, cell, spec, traffic, limits


def load_stage(traffic: dict, here: Path = HERE):
    return _load(here / "stages" / f"{traffic['stage']}.py",
                 f"perfbench_stage_{traffic['stage']}")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device: str = "cuda", root: Path = ROOT,
         here: Path = HERE, t_start: float = T_START) -> int:
    """``device``, ``root`` and ``here`` are for the tests, which drive a
    run on the CPU from a benchmark of their own."""
    args = parse(argv)
    # the build caches the program may use live inside the checkout
    cache = root / ".perfbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")
    try:
        bench, cell, spec, traffic, limits = load_cell(args.workload, root,
                                                       here)
    except KeyError as e:
        print(f"no such entry in BENCHMARK.json: {e}", file=sys.stderr)
        return 2

    if device == "cuda" and cell["chips"] == 1:
        pin()
    import torch
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    stage = load_stage(traffic, here)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    res = stage.run(spec, traffic, args.seed, args.seconds,
                    bool(args.trace), device, log)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    setup_s = res["setup_end"] - t_start

    # the reference, once the program's state is freed
    from perfbench import check as check_mod
    inputs = res.pop("check_inputs")
    t_ref = time.time()
    ref = stage.check(inputs)
    log(f"[perfbench] reference check: {time.time() - t_ref:.2f} s")
    nums = check_mod.numbers(inputs["program"], ref)
    for p, r in ref.items():
        if "grad1" not in r:
            continue
        log(f"[perfbench] reference first-gradient norms by leaf "
            f"({p or 'window'}): "
            + " ".join(f"{k}={v:.4g}" for k, v in r["grad1"].items()))
    correct = check_mod.judge(nums, limits)
    del inputs
    gc.collect()

    e2e = dict(res["end_to_end"], setup_s=setup_s)
    metrics = {}
    breakdown = None
    if args.trace:
        ctx = {"trace": res.get("trace"), "work": res.get("work"),
               "window_s": res["window_s"],
               "device_kind": (torch.cuda.get_device_name()
                               if device == "cuda" else "cpu"),
               "program_kernels": program_kernels(root)}
        for m in bench["per_layer"]:
            if not _applies(m, cell["name"]):
                continue
            reader = _load(here / "metrics" / f"{m['name']}.py",
                           f"perfbench_metric_{m['name']}")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = res.get("trace")
        if tr:
            breakdown = {"device_ops": tr["device_ops"],
                         "idle_gaps": tr["idle_gaps"]}
    else:
        for m in bench["end_to_end"]:
            if _applies(m, cell["name"]):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": (torch.cuda.get_device_name() if device == "cuda"
                         else device),
                "count": cell["chips"],
                "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        dev_info["busy_s"] = res["trace"]["busy_s"] if res.get("trace") \
            else 0.0
        dev_info["window_s"] = res["window_s"]
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev_info,
            "card": card_label() if device == "cuda" else device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = {k: {"value": nums[k], "limit": limits[k]}
                     for k in limits}
    for k in limits:
        print(f"check {k} {nums[k]!r} limit {limits[k]!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def program_kernels(root: Path) -> set[str]:
    """Names of the kernels the program builds from its csrc/ sources."""
    import re
    names = set()
    for p in (root / "freesurgs_tpu_torch" / "csrc").glob("*.cu"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
            p.read_text()))
    return names


if __name__ == "__main__":
    sys.exit(main())
