"""Carry state over from numpy arrays: the Gaussian field, the pose table and
Adam moments, keyed by the JAX package's field names.

Callers build the dicts with ``np.asarray`` from the JAX objects; nothing
of the JAX package is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gaussians import PARAM_NAMES, GaussianField
from .models.pose import PoseTable
from .train.optim import AdamState

FIELD_KEYS = PARAM_NAMES + ("active", "max_radii2d", "grad_accum",
                            "grad_denom", "scene_radius")


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def field_from_numpy(arrays: dict[str, np.ndarray], device="cuda",
                     max_sh_degree: int = 3) -> GaussianField:
    """GaussianField from arrays named like the JAX GaussianField's fields."""
    missing = [k for k in FIELD_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"missing field arrays: {missing}")
    kw = {k: _t(arrays[k], device) for k in FIELD_KEYS}
    kw["active"] = kw["active"].to(torch.bool)
    for k in FIELD_KEYS:
        if k != "active":
            kw[k] = kw[k].to(torch.float32)
    return GaussianField(**kw, max_sh_degree=max_sh_degree)


def poses_from_numpy(quats: np.ndarray, trans: np.ndarray,
                     device="cuda") -> PoseTable:
    return PoseTable(quats=_t(quats, device, torch.float32),
                     trans=_t(trans, device, torch.float32))


def adam_from_numpy(mu: dict[str, np.ndarray], nu: dict[str, np.ndarray],
                    count: int, device="cuda") -> AdamState:
    """AdamState from moment dicts keyed like the parameters."""
    return AdamState(mu={k: _t(v, device, torch.float32) for k, v in mu.items()},
                     nu={k: _t(v, device, torch.float32) for k, v in nu.items()},
                     count=int(count))
