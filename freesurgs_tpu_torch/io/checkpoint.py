"""Checkpoints (port of ``freesurgs_tpu/io/checkpoint.py``).

A checkpoint is a directory holding ``state.pt``: ``torch.save`` of
{"state": tree, "step": int}, where the tree is nested dicts and lists of
tensors and plain values, read back with ``weights_only=True``. Beside the
directory, ``<path>.meta.json`` holds the small shape metadata (capacity,
keyframe count, ...) a fresh process reads to build a Trainer of the right
shape before it touches the state. Names follow the JAX package:
``ckpt_final``, ``ckpt_<7-digit iteration>``, ``ckpt_progressive``. The
port does not read the JAX package's orbax checkpoints (``convert.py``
carries state across).
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

STATE_FILE = "state.pt"


def save_checkpoint(path: str, state: Any, step: int,
                    meta: dict | None = None):
    """Write ``state`` (nested dicts / lists of tensors and plain values) at
    ``path`` (a directory), and ``meta`` as ``<path>.meta.json``. The file
    is written under a temporary name and renamed, so a crash mid-save
    leaves the previous checkpoint whole."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    dst = os.path.join(path, STATE_FILE)
    tmp = dst + ".tmp"
    torch.save({"state": state, "step": int(step)}, tmp)
    os.replace(tmp, dst)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def restore_checkpoint(path: str, map_location=None):
    """(state, step) of the checkpoint at ``path``; tensors go to
    ``map_location`` (as saved when None)."""
    ckpt = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location=map_location, weights_only=True)
    return ckpt["state"], int(ckpt["step"])


def latest_checkpoint(model_dir: str) -> str | None:
    """The newest checkpoint under a run directory: ``ckpt_final`` if
    training completed, else the highest-numbered ``ckpt_<iter>``, else
    ``ckpt_progressive``; None when there is none."""
    final = os.path.join(model_dir, "ckpt_final")
    if os.path.isdir(final):
        return final
    numbered = []
    if os.path.isdir(model_dir):
        for name in os.listdir(model_dir):
            if name.startswith("ckpt_") and os.path.isdir(
                    os.path.join(model_dir, name)):
                suffix = name[len("ckpt_"):]
                if suffix.isdigit():
                    numbered.append((int(suffix), name))
    if numbered:
        return os.path.join(model_dir, max(numbered)[1])
    prog = os.path.join(model_dir, "ckpt_progressive")
    return prog if os.path.isdir(prog) else None


def load_checkpoint_meta(path: str) -> dict | None:
    """The shape-metadata sidecar (None for a checkpoint without one)."""
    p = os.path.abspath(path) + ".meta.json"
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)
