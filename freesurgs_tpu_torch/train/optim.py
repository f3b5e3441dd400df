"""Adam with per-leaf learning rates and moment surgery
(port of ``freesurgs_tpu/train/optim.py``).

Not ``torch.optim``: densification edits the moments slot by slot, which a
transparent dict of moments makes a masked write. Semantics are
torch.optim.Adam's (the reference's): one shared step count, bias
correction 1 - beta^t, update lr * m_hat / (sqrt(v_hat) + eps), eps=1e-15.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class AdamState:
    mu: dict[str, torch.Tensor]     # first moments, keyed like the params
    nu: dict[str, torch.Tensor]     # second moments
    count: int = 0                  # shared step count


def adam_init(params: dict[str, torch.Tensor]) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=0)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adam_update(grads: dict[str, torch.Tensor], state: AdamState, lrs,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """Returns (updates to ADD to the params, new state). ``lrs`` is a dict
    keyed like ``grads`` or one scalar; scalars may be tensors."""
    count = state.count + 1
    any_g = next(iter(grads.values()))
    t = _f32(float(count), any_g)
    bc1 = 1.0 - _f32(b1, any_g) ** t       # f32, as the JAX package
    bc2 = 1.0 - _f32(b2, any_g) ** t
    mu = {k: b1 * state.mu[k] + (1.0 - b1) * g for k, g in grads.items()}
    nu = {k: b2 * state.nu[k] + (1.0 - b2) * g * g for k, g in grads.items()}
    if not isinstance(lrs, dict):
        lrs = {k: lrs for k in grads}
    updates = {k: -lrs[k] * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
               for k in grads}
    return updates, AdamState(mu=mu, nu=nu, count=count)


def apply_updates(params: dict[str, torch.Tensor],
                  updates: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: p + updates[k] for k, p in params.items()}


def surgery_mask_moments(state: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero the moments of slots where ``mask`` (C,) is True."""
    def zero(x):
        m = mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(m, torch.zeros_like(x), x)

    return dataclasses.replace(state,
                               mu={k: zero(v) for k, v in state.mu.items()},
                               nu={k: zero(v) for k, v in state.nu.items()})


def expon_lr(step, lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             device=None) -> torch.Tensor:
    """Log-linear LR decay (the reference's ``get_expon_lr_func``), in f32."""
    step = torch.as_tensor(step, dtype=torch.float32, device=device)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    li = torch.log(torch.tensor(lr_init, dtype=torch.float32, device=device))
    lf = torch.log(torch.tensor(lr_final, dtype=torch.float32, device=device))
    return delay * torch.exp(li * (1.0 - t) + lf * t)


def tracking_lr(iter_idx: int, total_iters: int, base_lr: float = 0.01,
                gamma: float = 0.5, device=None) -> torch.Tensor:
    """Step-decayed tracking LR: halved at 0, 1/3 and 2/3 of the budget (the
    reference's MultiStepLR with milestone 0 firing before the first step)."""
    third = max(total_iters // 3, 1)
    n_hits = 1 + min(iter_idx // third, 2)
    g = torch.tensor(gamma, dtype=torch.float32, device=device)
    return base_lr * g ** float(n_hits)
