"""Typed configuration and its command-line flags
(port of ``freesurgs_tpu/io/config.py``).

One dataclass tree; ``add_to_parser`` / ``from_args`` make a flag of every
field (``--<group>_<field>``) and ``--train_override k=v`` for the
``TrainConfig`` fields. The flags and their defaults are the JAX package's,
name for name. Two keep their names and change meaning:

- ``--run_platform`` is the torch device: "" runs on the card ("cuda"),
  "cpu" on the CPU (``device``);
- ``--run_impl``: "" maps to None; anything but "" / "raster" is refused by
  ``train.steps.check_supported`` (the port renders through its kernels).

Configs serialize to JSON beside the run (``config.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field

from ..train.densify import DensifyConfig
from ..train.steps import TrainConfig


@dataclass
class DataConfig:
    source_path: str = ""
    data_type: str = "scared"
    frame_start: int = 0
    frame_end: int = -1
    sample_rate: int = 8          # test split stride
    depth_prior: str = "normalized"  # or "metric" (see data/scared.py)


@dataclass
class ModelConfig:
    sh_degree: int = 3
    capacity: int = 0             # 0 -> auto from init point count
    init_mask_frac: float = 0.1   # first-frame pixel subsample


@dataclass
class RunConfig:
    model_path: str = "./output/run"
    seed: int = 6666
    test: bool = False
    start_checkpoint: str = ""    # a checkpoint directory, or "latest"
    visualize: bool = False       # the web viewer; headless without viser
    port: int = 6009
    log_metrics: bool = True
    global_chunk: int = 100
    checkpoint_every: int = 5000  # global-stage periodic-save cadence
    impl: str = ""                # '' -> None; only the kernels' route
    max_instances: int = 0        # 0 -> the TrainConfig cap
    debug_nans: bool = False      # torch.autograd.set_detect_anomaly
    platform: str = ""            # torch device: '' -> cuda, or 'cpu'


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    run: RunConfig = field(default_factory=RunConfig)
    train_overrides: dict = field(default_factory=dict)

    def train_config(self) -> TrainConfig:
        kw = dict(self.train_overrides)
        kw.setdefault("impl", self.run.impl or None)
        kw.setdefault("max_instances", self.run.max_instances)
        if "densify" in kw and isinstance(kw["densify"], dict):
            kw["densify"] = DensifyConfig(**kw["densify"])
        return TrainConfig(**kw)

    def device(self) -> str:
        """The torch device of ``--run_platform``."""
        if self.run.platform not in ("", "cuda", "cpu"):
            raise ValueError(f"--run_platform {self.run.platform!r}: '' "
                             "(the card) or 'cpu'")
        return self.run.platform or "cuda"


def _iter_fields(cfg, prefix=""):
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            yield from _iter_fields(v, prefix + f.name + ".")
        elif isinstance(v, (int, float, str, bool)):
            yield prefix + f.name, v, cfg, f.name


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def add_to_parser(cfg: Config, parser: argparse.ArgumentParser):
    for path, default, _, _ in _iter_fields(cfg):
        flag = "--" + path.replace(".", "_")
        parser.add_argument(flag, default=default, type=(
            _parse_bool if isinstance(default, bool) else type(default)))
    parser.add_argument("--train_override", action="append", default=[],
                        help="k=v override for TrainConfig fields")
    return parser


def from_args(cfg: Config, args: argparse.Namespace) -> Config:
    for path, _, owner, name in _iter_fields(cfg):
        setattr(owner, name, getattr(args, path.replace(".", "_")))
    proto = TrainConfig()._asdict()
    for kv in args.train_override:
        k, v = kv.split("=", 1)
        if k not in proto:
            raise KeyError(f"unknown TrainConfig field {k}")
        if proto[k] is None or isinstance(proto[k], str):
            # str fields, and optional ones whose default is None (impl):
            # the raw string
            cfg.train_overrides[k] = v
        else:
            cfg.train_overrides[k] = type(proto[k])(json.loads(v))
    return cfg


def save_config(cfg: Config, path: str):
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


def load_config(path: str) -> Config:
    with open(path) as f:
        d = json.load(f)
    return Config(data=DataConfig(**d["data"]),
                  model=ModelConfig(**d["model"]), run=RunConfig(**d["run"]),
                  train_overrides=d.get("train_overrides", {}))
