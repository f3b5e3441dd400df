"""Multi-sequence data parallelism over the mesh's ``data`` axis (port of
``freesurgs_tpu/parallel/multiseq.py``).

N independent sequences train at once, one per data index: each holds its
own Gaussian field, pose table and video, and runs the ordinary
single-view, densify-on ``mapping_chunk`` on its own sequence, with the
rank's tiles group band-sharding its renders (none when the row has one
rank). No collective runs between sequences; only the chunk's
diagnostics are all-gathered over the data group.

SPMD: a process holds its own sequence's state. ``shard_states`` takes
this rank's state out of a stack, and ``multiseq_mapping_chunk`` takes and
returns it, while its other inputs keep JAX's leading data axis.
``MappingState`` carries a CPU ``torch.Generator``, which does not stack:
a stack keeps one generator per sequence, and each rank takes its own.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.camera import Camera
from ..train.steps import MappingState, TrainConfig, mapping_chunk
from .mesh import TILE_AXIS, Mesh, all_gather_cat


def _stack(*xs):
    x = xs[0]
    if torch.is_tensor(x):
        return torch.stack(xs)
    if isinstance(x, dict):
        return {k: _stack(*(y[k] for y in xs)) for k in x}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _stack(*(getattr(y, f.name) for y in xs))
            for f in dataclasses.fields(x)})
    return tuple(xs)             # generators, counters, static ints


def _take(x, i: int, device=None):
    """Sequence i of a stack, as tensors of its own (a view would let the
    in-place cache writes of ``mapping_chunk`` reach the stack)."""
    if torch.is_tensor(x):
        return x[i].to(device=device).clone()
    if isinstance(x, dict):
        return {k: _take(v, i, device) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _take(getattr(x, f.name), i, device)
            for f in dataclasses.fields(x)})
    return x[i]


def stack_states(states: list[MappingState]) -> MappingState:
    """Stack per-sequence training states along a leading data axis."""
    return _stack(*states)


def shard_states(mesh: Mesh, stacked: MappingState) -> MappingState:
    """This rank's sequence of a stack, on the mesh's device."""
    return _take(stacked, mesh.data_index, mesh.device)


def unstack_states(stacked: MappingState, k: int) -> list[MappingState]:
    return [_take(stacked, i) for i in range(k)]


def _gather_aux(aux: dict, group) -> dict:
    """Every sequence's value of each diagnostic, stacked on a leading data
    axis, by one all-gather of the leaves as float64 (exact for f32 values
    and integer counts); None stays None."""
    leaves = []

    def flat(x):
        if isinstance(x, dict):
            return {k: flat(v) for k, v in x.items()}
        if x is None:
            return None
        t = torch.as_tensor(x)
        leaves.append(t)
        return len(leaves) - 1

    tree = flat(aux)
    dev = next((t.device for t in leaves if t.is_cuda), leaves[0].device)
    vec = torch.cat([t.to(dev, torch.float64).reshape(-1) for t in leaves])
    rows = all_gather_cat(vec[None], group)
    out, off = [], 0
    for t in leaves:
        out.append(rows[:, off:off + t.numel()].reshape(
            (rows.shape[0],) + tuple(t.shape)).to(t.dtype))
        off += t.numel()

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return None if node is None else out[node]

    return build(tree)


def multiseq_mapping_chunk(mesh: Mesh, state: MappingState, colors_all,
                           monodeps_all, w2c_all, cur_ts, cam: Camera,
                           cfg: TrainConfig, sh_degree: int = 0):
    """One mapping chunk on every sequence at once.

    ``state`` is this rank's sequence's (``shard_states``, or a previous
    call's); colors_all, monodeps_all, w2c_all and cur_ts carry a leading
    data axis of mesh.shape['data'], of which this rank maps row
    ``mesh.data_index`` with the single-view, densify-on
    ``mapping_chunk``. Returns (this rank's state, aux), each diagnostic of
    aux with the leading data axis (``aux["loss"]`` is (d,))."""
    i = mesh.data_index
    dev = state.field.means.device
    ts = [int(t) for t in cur_ts[i]]
    st, aux = mapping_chunk(
        state, torch.as_tensor(colors_all[i], device=dev),
        torch.as_tensor(monodeps_all[i], device=dev),
        torch.as_tensor(w2c_all[i], device=dev), ts, [], cam, cfg,
        two_views=False, sh_degree=sh_degree, densify_enabled=True,
        mesh=mesh if mesh.shape[TILE_AXIS] > 1 else None)
    return st, _gather_aux(aux, mesh.data_group)
