"""Produce the ``flow/`` and ``monodep/`` inputs from raw frames (port of
``scripts/produce_inputs.py``).

  python -m freesurgs_tpu_torch.cli.produce_inputs --root <dir> \
      [--flow hs|<module>] [--depth parallax|<module>] [--levels 5] \
      [--overwrite] [--device cuda|cpu]

From a directory that holds ``<root>/input/*.png`` it writes, in the layout
``data/scared.load_scared`` reads (float32, key ``pred``):

  <root>/flow/flow_fw_<stem>.npz   (2, H, W) forward flow in pixels
  <root>/flow/flow_bw_<stem>.npz   (2, H, W) backward flow
  <root>/monodep/depth_<stem>.npz  (H, W) disparity

Backends: ``--flow hs`` is multi-scale Horn-Schunck (``data/flow_hs.py``),
``--depth parallax`` the median-compensated parallax proxy from each
frame's flow pair (the loader min-max normalizes, so its scale does not
matter); a module name instead loads that module and calls its
``flow(img0_3hw, img1_3hw) -> (2, H, W)`` or ``depth(img_3hw) -> (H, W)``
on numpy frames. Flow files that exist are loaded, not recomputed, unless
``--overwrite``; so are disparity files. Frames decode with the port's PNG
codec; a JPEG frame raises. The built-in backends run on the card unless
``--device cpu``; without a CUDA device the command fails.
"""

from __future__ import annotations

import argparse
import glob
import importlib
import os
import sys
import time

import numpy as np
import torch

from ..data.flow_hs import hs_flow, parallax_disparity
from ..io.png import read_png


def load_frames(root: str):
    """(frames as (3, H, W) float32 [0, 1], stems) of ``<root>/input``."""
    paths = sorted(glob.glob(os.path.join(root, "input", "*.png"))
                   + glob.glob(os.path.join(root, "input", "*.jpg"))
                   + glob.glob(os.path.join(root, "input", "*.jpeg")))
    if not paths:
        raise FileNotFoundError(f"no frames under {root}/input")
    for p in paths:
        if not p.endswith(".png"):
            raise NotImplementedError(
                f"{p}: the port decodes PNG frames only (io/png.py); "
                "convert JPEG frames to PNG first")
    imgs = [read_png(p).astype(np.float32).transpose(2, 0, 1) / 255.0
            for p in paths]
    stems = [os.path.basename(p).split(".")[0] for p in paths]
    return imgs, stems


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def produce(root: str, flow: str = "hs", depth: str = "parallax",
            levels: int = 5, overwrite: bool = False, device="cuda",
            log=print) -> dict:
    """Write the flow and disparity files of ``root``. Returns
    {"flow_pairs": computed, "flow_seconds": seconds of each computed pair
    (forward and backward), "depth_maps": disparity files written}."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to produce "
                           "the inputs on the CPU")
    if flow == "hs":
        def flow_pair(a, b):
            x = torch.from_numpy(np.stack([a, b])).to(dev)
            y = torch.from_numpy(np.stack([b, a])).to(dev)
            fb = hs_flow(x, y, levels=levels).cpu().numpy()
            return fb[0], fb[1]
    else:
        mod = importlib.import_module(flow)

        def flow_pair(a, b):
            return np.asarray(mod.flow(a, b)), np.asarray(mod.flow(b, a))

    depth_fn = None
    if depth != "parallax":
        mod_d = importlib.import_module(depth)
        depth_fn = lambda a: np.asarray(mod_d.depth(a))  # noqa: E731

    imgs, stems = load_frames(root)
    os.makedirs(os.path.join(root, "flow"), exist_ok=True)
    os.makedirs(os.path.join(root, "monodep"), exist_ok=True)

    flows, seconds = {}, []
    for t in range(len(imgs) - 1):
        fw_path = os.path.join(root, "flow", f"flow_fw_{stems[t]}.npz")
        bw_path = os.path.join(root, "flow", f"flow_bw_{stems[t]}.npz")
        if os.path.exists(fw_path) and not overwrite:
            flows[t] = (np.load(fw_path)["pred"], np.load(bw_path)["pred"])
            continue
        _sync(dev)
        t0 = time.perf_counter()
        fw, bw = flow_pair(imgs[t], imgs[t + 1])
        seconds.append(time.perf_counter() - t0)
        fw, bw = fw.astype(np.float32), bw.astype(np.float32)
        np.savez(fw_path, pred=fw)
        np.savez(bw_path, pred=bw)
        flows[t] = (fw, bw)
        log(f"flow {stems[t]}: |fw| median "
            f"{np.median(np.hypot(fw[0], fw[1])):.2f}px")

    n_depth = 0
    for t in range(len(imgs)):
        dpath = os.path.join(root, "monodep", f"depth_{stems[t]}.npz")
        if os.path.exists(dpath) and not overwrite:
            continue
        if depth_fn is not None:
            disp = depth_fn(imgs[t])
        else:
            # the parallax proxy needs a flow pair; the end frames reuse
            # their single neighbouring pair
            fw, _ = flows.get(t, flows[len(imgs) - 2])
            _, bw = flows.get(t - 1, flows[0])
            disp = parallax_disparity(torch.from_numpy(fw).to(dev),
                                      torch.from_numpy(bw).to(dev)
                                      ).cpu().numpy()
        np.savez(dpath, pred=disp.astype(np.float32))
        n_depth += 1
    log(f"wrote {len(seconds)} flow pairs + {n_depth} disparity maps "
        f"under {root}")
    return {"flow_pairs": len(seconds), "flow_seconds": seconds,
            "depth_maps": n_depth}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--flow", default="hs")
    ap.add_argument("--depth", default="parallax")
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    produce(args.root, flow=args.flow, depth=args.depth, levels=args.levels,
            overwrite=args.overwrite, device=args.device,
            log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
