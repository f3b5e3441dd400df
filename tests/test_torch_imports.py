"""The port and ``chip_smoke.py`` run on a machine without JAX, PIL or cv2:
importing every module of ``freesurgs_tpu_torch``, and every module that
``chip_smoke.py`` imports (at top level or inside its functions), must load
neither ``jax`` nor any module of the JAX package ``freesurgs_tpu``, nor
``PIL`` nor ``cv2``.

Each case runs in a fresh interpreter where ``sys.modules[name] = None``
for ``jax``, ``PIL`` and ``cv2``, so importing any of them raises, and then
checks ``sys.modules`` for the JAX package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# The raw-frames path (producers, PnP init): modules that must exist and
# import without jax, PIL or cv2 (the JAX PnP init calls cv2).
RAW_FRAMES_MODULES = {"freesurgs_tpu_torch.core.warp",
                      "freesurgs_tpu_torch.data.flow_hs",
                      "freesurgs_tpu_torch.cli.produce_inputs",
                      "freesurgs_tpu_torch.models.pnp",
                      "freesurgs_tpu_torch.models.pose"}

_PROBE = """
import importlib, pkgutil, sys
for blocked in ("jax", "PIL", "cv2"):
    sys.modules[blocked] = None
sys.path.insert(0, {repo!r})
names = {names!r}
if names is None:
    import freesurgs_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   "freesurgs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "freesurgs_tpu", "PIL", "cv2"))
print(len(names), bad)
assert not bad, bad
"""


def _chip_smoke_imports() -> list[str]:
    """Every module chip_smoke.py imports, at any depth of its code."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return sorted(names - {"__future__"})


@pytest.mark.parametrize("which", ["package", "chip_smoke"])
def test_port_imports_no_jax(which):
    names = None if which == "package" else _chip_smoke_imports()
    if names is not None:
        assert any(n.startswith("freesurgs_tpu_torch") for n in names)
    res = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=str(REPO), names=names)],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    n_mods = int(res.stdout.split()[0])
    assert n_mods >= (50 if which == "package" else 5), res.stdout
    if which == "package":
        import pkgutil

        import freesurgs_tpu_torch as pkg
        walked = {m.name for m in pkgutil.walk_packages(
            pkg.__path__, "freesurgs_tpu_torch.")}
        assert RAW_FRAMES_MODULES <= walked, RAW_FRAMES_MODULES - walked
