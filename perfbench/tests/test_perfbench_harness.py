"""The harness: what it may import, that it finds cells, configurations,
stage drivers and metrics by name, and that a broken timed path comes out
as not correct."""

import ast
import dataclasses
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from perfbench import run
from perfbench.tests import tiny

PERFBENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "freesurgs_tpu"}


def _imports(path: Path):
    """Top-level names of a module's absolute imports."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PERFBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_jax_import(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if "reference" in path.relative_to(PERFBENCH).parts:
        assert "freesurgs_tpu_torch" not in names


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, perfbench.reference.mapping, "
            "perfbench.reference.tracking, perfbench.scene, "
            "perfbench.check, perfbench.work.counts; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('freesurgs')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PERFBENCH.parent, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "freesurgs_tpu_torch_like", sys)
    assert "freesurgs_tpu_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.forbidden_modules()


DUMMY_STAGE = '''
def run(spec, traffic, seed, seconds, trace, device, log):
    readings = {"losses": [1.0], "grad1": {"a": 1.0}, "change": {"a": 1.0}}
    return {"setup_end": 0.0, "attempted": traffic["iterations"],
            "failed": 0, "memory_peak_bytes": 0, "window_s": 1.0,
            "end_to_end": {"global_it_per_s": float(spec["rate"])},
            "check_inputs": {"program": {"": readings}},
            "trace": {"busy_s": 0.5, "launches": 7, "iterations": 7,
                      "device_ops": [], "idle_gaps": []}}


def check(inputs):
    return inputs["program"]
'''


def test_harness_takes_new_files_by_name(tmp_path, capsys):
    root, here = tiny.make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "perfbench" / "configs" / "dummy.json").write_text(
        json.dumps({"rate": 42}))
    bench["configs"].append({"name": "dummy", "source": "a test",
                             "file": "perfbench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy",
                               "traffic": "dummy", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "global_it_per_s",
                               "workloads": ["dummy.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "global_it_per_s":
            m["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (here / "traffic" / "dummy.json").write_text(
        json.dumps({"stage": "dummy_stage", "iterations": 7}))
    (here / "stages" / "dummy_stage.py").write_text(DUMMY_STAGE)
    (here / "metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n    return 100.0 * ctx['trace']['busy_s']\n")
    (here / "workloads" / "dummy.cell.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.0}}))
    for trace in (0, 1):
        assert run.main(["--workload", "dummy.cell", "--seed", "1",
                         "--seconds", "1", "--trace", str(trace)],
                        device="cpu", root=root, here=here, t_start=0.0) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    plain, traced = json.loads(lines[-2]), json.loads(lines[-1])
    assert plain["correct"] and plain["attempted"] == 7
    assert plain["metrics"]["global_it_per_s"]["value"] == 42.0
    assert traced["metrics"] == {"dummy_metric": {"value": 50.0,
                                                  "unit": "%"}}
    assert list(traced)[-1] == "check"


def _run_cell(tmp_path, capsys, cell="cfg34.global"):
    root, here = tiny.make_root(tmp_path)
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 3),
                   "--seconds", "1", "--trace", "0"], device="cpu",
                  root=root, here=here, t_start=time.time())
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("cell", ["cfg34.global", "ref.global"])
def test_sound_run_is_correct(tmp_path, capsys, cell):
    out = _run_cell(tmp_path, capsys, cell)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_state_left_unchanged_is_not_correct(tmp_path, capsys,
                                             monkeypatch):
    from freesurgs_tpu_torch.train import loop, steps
    real = steps.mapping_chunk

    def unchanged(state, *a, **kw):
        _, aux = real(state, *a, **kw)
        return state, aux

    monkeypatch.setattr(steps, "mapping_chunk", unchanged)
    monkeypatch.setattr(loop, "mapping_chunk", unchanged)
    out = _run_cell(tmp_path, capsys)
    assert not out["correct"]
    assert out["check"]["change_gap"]["value"] > 0.5


def test_half_batch_left_out_is_not_correct(tmp_path, capsys, monkeypatch):
    from freesurgs_tpu_torch.train import losses
    real = losses.rgb_loss

    def half_rows(img, gt, mask=None, **kw):
        h = img.shape[1] // 2
        return real(img[:, :h], gt[:, :h], mask=mask, **kw)

    monkeypatch.setattr(losses, "rgb_loss", half_rows)
    out = _run_cell(tmp_path, capsys)
    assert not out["correct"]
    assert out["check"]["loss_gap"]["value"] > \
        out["check"]["loss_gap"]["limit"]


class _FastProgram:
    """A program whose chunks take no time: it records the iterations each
    chunk maps and fails at an opacity reset, as the window must never
    reach one however many chunks fit in it."""

    def __init__(self, start, reset_every):
        self.state = _State(iteration=start, opt=_Opt(count=start))
        self.reset_every = reset_every
        self.mapped = []

    def global_run(self, n):
        st = self.state
        its = list(range(st.iteration + 1, st.iteration + n + 1))
        assert all(i % self.reset_every for i in its), its
        assert st.opt.count == st.iteration
        self.mapped.append((its[0], its[-1]))
        self.state = dataclasses.replace(
            st, iteration=its[-1],
            opt=dataclasses.replace(st.opt, count=its[-1]))


@dataclasses.dataclass
class _Opt:
    count: int


@dataclasses.dataclass
class _State:
    iteration: int
    opt: _Opt


def test_window_never_reaches_the_opacity_reset():
    stage = run.load_stage({"stage": "global_run"})
    fast = _FastProgram(21000, 3000)
    n = stage.window(fast, 250, 21000, lambda done: done < 40)
    assert n == 40 and set(fast.mapped) == {(21001, 21250)}
    cfg = types.SimpleNamespace(densify_until=15000,
                                opacity_reset_interval=3000)
    stage._check_window_clear(cfg, 21000, 250)
    for start, chunk in ((23800, 250), (14000, 250)):
        with pytest.raises(RuntimeError):
            stage._check_window_clear(cfg, start, chunk)
