"""Binary PLY export / import of the Gaussian cloud, 3DGS layout
(port of ``freesurgs_tpu/io/ply.py``).

Properties x y z nx ny nz f_dc_* f_rest_* opacity scale_* rot_*, little-
endian float32, readable by the usual 3DGS viewers. ``field_to_ply`` writes
the JAX function's bytes for the same field: the active rows, "opacity"
(the ecosystem name; "_opacity" is accepted on load) and explicit widths,
so a field with no active row still exports a valid, empty PLY.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gaussians import GaussianField


def field_to_ply(field: GaussianField, path: str):
    act = field.active.cpu().numpy()

    def rows(x):
        return x.detach().cpu().numpy()[act]

    xyz = rows(field.means)
    n = xyz.shape[0]
    dc, rest = rows(field.sh_dc), rows(field.sh_rest)
    f_dc = dc.transpose(0, 2, 1).reshape(n, dc.shape[1] * 3)
    f_rest = rest.transpose(0, 2, 1).reshape(n, rest.shape[1] * 3)
    opac = rows(field.logit_opacity)[:, None]
    scale, rot = rows(field.log_scales), rows(field.quats)

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scale.shape[1])]
             + [f"rot_{i}" for i in range(rot.shape[1])])
    data = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc, f_rest, opac, scale, rot],
        axis=1).astype("<f4")
    header = (["ply", "format binary_little_endian 1.0",
               f"element vertex {n}"]
              + [f"property float {nm}" for nm in names] + ["end_header"])
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def load_ply_arrays(path: str) -> dict[str, np.ndarray]:
    """A float32 binary PLY as a dict of named columns."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        if b"binary_little_endian" not in f.readline():
            raise ValueError(f"{path}: only binary little-endian PLY")
        props, n = [], 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            line = line.decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        raw = np.frombuffer(f.read(n * len(props) * 4), "<f4")
    cols = raw.reshape(n, len(props))
    return {p: cols[:, i].copy() for i, p in enumerate(props)}


def ply_to_field(path: str, max_sh_degree: int = 3,
                 capacity: int | None = None,
                 device="cuda") -> GaussianField:
    """A GaussianField of ``capacity`` slots (the row count when None)
    holding the PLY's rows, active, in front."""
    cols = load_ply_arrays(path)
    n = cols["x"].shape[0]
    k = (max_sh_degree + 1) ** 2
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1)
    sh_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :]
    n_rest = 3 * (k - 1)
    if n_rest and f"f_rest_{n_rest - 1}" in cols:
        rest = np.stack([cols[f"f_rest_{i}"] for i in range(n_rest)], -1)
        sh_rest = rest.reshape(n, 3, k - 1).transpose(0, 2, 1)
    else:
        sh_rest = np.zeros((n, k - 1, 3), np.float32)
    opac = cols.get("opacity", cols.get("_opacity"))
    scale = np.stack([cols[f"scale_{i}"] for i in range(3)], -1)
    rot = np.stack([cols[f"rot_{i}"] for i in range(4)], -1)

    cap = capacity or n
    dev = torch.device(device)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(dev)

    quats = pad(rot)
    quats[n:, 0] = 1.0

    def zeros():
        return torch.zeros(cap, dtype=torch.float32, device=dev)

    return GaussianField(
        means=pad(xyz), quats=quats, log_scales=pad(scale),
        logit_opacity=pad(opac), sh_dc=pad(sh_dc), sh_rest=pad(sh_rest),
        active=torch.arange(cap, device=dev) < n, max_radii2d=zeros(),
        grad_accum=zeros(), grad_denom=zeros(),
        scene_radius=torch.tensor(1.0, dtype=torch.float32, device=dev),
        max_sh_degree=max_sh_degree)
