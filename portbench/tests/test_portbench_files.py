"""The benchmark's files: found by name, added to without an edit, and
kept apart from the JAX package (and the reference from the program)."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_under_portbench_imports_jax_or_the_jax_package():
    for f in PKG.rglob("*.py"):
        bad = _imports(f) & {"jax", "jaxlib", "flax", "nestmc"}
        assert not bad, (f, bad)


def test_the_yardstick_imports_nothing_of_the_program():
    refs = sorted((PKG / "models").glob("*_reference.py"))
    assert refs
    for path in [PKG / name for name in ("reference.py", "check.py",
                                         "ess.py", "roofline.py",
                                         "trace.py")] + refs:
        assert "nestmc_torch" not in _imports(path), path


def test_a_model_module_imports_the_program_inside_its_functions_only():
    for f in (PKG / "models").glob("*.py"):
        tree = ast.parse(f.read_text())
        top = set()
        for node in tree.body:
            if isinstance(node, ast.Import):
                top |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                top.add(node.module.split(".")[0])
        assert "nestmc_torch" not in top, f


# what only a model's module may know
MODEL_WORDS = ("hier_logistic", "beta", "Logit", "obs_per_group",
               "covariates")


def test_no_code_outside_the_models_names_a_model():
    for f in PKG.rglob("*.py"):
        rel = f.relative_to(PKG)
        if rel.parts[0] in ("models", "tests"):
            continue
        text = f.read_text()
        assert not [w for w in MODEL_WORDS if w in text], (rel, [
            w for w in MODEL_WORDS if w in text])


def test_forbidden_modules_are_compared_by_whole_top_level_names(
        monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "nestmc_torch_like", types.ModuleType(
        "nestmc_torch_like"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nestmc.engine",
                        types.ModuleType("nestmc.engine"))
    assert harness.forbidden_modules() == ["nestmc"]


def test_benchmark_json_keeps_to_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == (
            c["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (PKG / "workloads" / f"{w['name']}.json").exists()
        assert (PKG / "traffic" / f"{w['traffic']}.json").exists()
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (PKG / "metrics" / f"{m['name']}.py").exists()
        names.add(m["name"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    assert len(names) == len(spec["end_to_end"]) + len(spec["per_layer"])
    assert len(json.dumps(spec)) < 64 * 1024


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_cell_and_metric_are_files_and_entries(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric by adding files under portbench/ and entries to
    BENCHMARK.json: the harness finds them, and no file it had changes."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(pkg)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((PKG / "configs" / "judged.json").read_text())
    (pkg / "configs" / "judged-2k.json").write_text(json.dumps(
        dict(cfg, name="judged-2k", groups=2000, reduced=[])))
    (pkg / "traffic" / "sample.long.json").write_text(json.dumps(
        {"chain_shards": 1, "group_shards": 1,
         "calibrate_draws": 128, "trace_draws": 32}))
    (pkg / "workloads" / "judged-2k.sample.long.json").write_text(
        json.dumps({"limits": {"step_gap": 1e-3, "carry_gap": 1e-3,
                               "rhat_gap": 1e-3}}))
    (pkg / "metrics" / "device.busy_ms_per_sweep.py").write_text(
        "def read(ctx):\n"
        "    t = ctx.trace\n"
        "    return None if t is None else 1e3 * t.busy_s / t.sweeps\n")
    spec["configs"].append({"name": "judged-2k", "source": "x",
                            "file": "portbench/configs/judged-2k.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "judged-2k.sample.long",
                              "config": "judged-2k",
                              "traffic": "sample.long", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "device.busy_ms_per_sweep",
                              "unit": "ms/sweep", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "sweeps_per_s",
                              "workloads": ["judged-2k.sample.long"]})
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps(spec))

    cell = harness.load_cell("judged-2k.sample.long", bench, here=pkg)
    assert cell.config["groups"] == 2000 and cell.chips == 1
    assert cell.traffic["calibrate_draws"] == 128
    assert cell.limits["step_gap"] == 1e-3
    assert "device.busy_ms_per_sweep" in [m["name"] for m in cell.per_layer]
    assert "collectives.ms_per_sweep" not in [m["name"]
                                              for m in cell.per_layer]
    read = harness.reader("device.busy_ms_per_sweep", here=pkg)
    assert read(harness.Context(cell, {}, None, {})) is None
    old = harness.load_cell("judged.sample", bench, here=pkg)
    assert "device.busy_ms_per_sweep" not in [m["name"]
                                              for m in old.per_layer]
    after = _digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_config_of_a_new_model_module_runs_through_the_harness(tmp_path):
    """A later change adds a model by adding its module under
    portbench/models/ (here a copy of the hierarchical logistic one under
    another name), a configuration that names it, a cell and its limits:
    the harness runs it through the tiny CPU path, and no file it had
    changes."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(pkg)
    shutil.copy(PKG / "models" / "hier_logistic.py",
                pkg / "models" / "other_model.py")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((PKG / "configs" / "judged.json").read_text())
    (pkg / "configs" / "other.json").write_text(json.dumps(
        dict(cfg, name="other", model="other_model")))
    (pkg / "workloads" / "other.sample.json").write_text(
        (PKG / "workloads" / "judged.sample.json").read_text())
    spec["configs"].append({"name": "other", "source": "x",
                            "file": "portbench/configs/other.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "other.sample", "config": "other",
                              "traffic": "sample", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys, portbench; from portbench.tests import _tiny; "
            "r = _tiny.run_tiny('other.sample'); "
            "print(json.dumps([portbench.__file__, "
            "'portbench.models.other_model' in sys.modules, r]))")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
            [str(tmp_path), str(ROOT)])))
    assert out.returncode == 0, out.stderr[-3000:]
    where, loaded, r = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(where).resolve().parent == pkg.resolve()
    assert loaded
    assert r["correct"] is True, r["check"]
    assert r["attempted"] == (16 + 2) * cfg["covariates"]
    after = _digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no-such.cell", ROOT / "BENCHMARK.json")
