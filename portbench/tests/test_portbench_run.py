"""A whole run on the CPU at a size a test can hold (the harness's look for
a card skipped): the result line, the check against the plain reference,
its control, and the faults the check has to catch."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import check
from portbench.tests import _tiny

ROOT = Path(__file__).resolve().parents[2]
# every cell of the benchmark, each in one process here
CELLS = tuple(w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"])


def _in_subprocess(cell, fault, control=False):
    """run_tiny in a fresh process (a planted fault dies with it)."""
    code = ("import json, sys; from portbench.tests import _tiny; "
            f"r = _tiny.run_tiny({cell!r}, {fault!r}, control={control}); "
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_the_result_line(cell):
    r = _in_subprocess(cell, None)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "check"
    assert r["correct"] is True
    tiny = _tiny.tiny_cell(cell)
    assert r["attempted"] == tiny.model.parameters(tiny.config)
    assert set(r["metrics"]) == {"ess_per_s", "min_ess_per_s",
                                 "sweeps_per_s", "warmup_sweeps_per_s",
                                 "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    for k in check.NUMBERS:
        assert r["check"][k]["value"] < r["check"][k]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell):
    """The reference in TF32 in the program's place: the line's own check
    reads the control's numbers, and one is over its limit."""
    r = _in_subprocess(cell, None, control=True)
    assert r["correct"] is False, r["check"]
    assert not check.decide({k: v["value"] for k, v in r["check"].items()},
                            {k: v["limit"] for k, v in r["check"].items()})


# the number each fault has to put over its limit (None: any of them)
FAULTS = {"unchanged": None, "half": None, "altered": None,
          "late": "step_gap", "keys": "step_gap",
          "unadapted": "warmup_gap", "short": "warmup_gap"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = _in_subprocess(cell, fault)
    assert r["correct"] is False, r["check"]
    number = FAULTS[fault]
    if number is not None:
        assert not r["check"][number]["value"] < r["check"][number][
            "limit"], r["check"]


def _sharded(fault, tmp_path):
    out = tmp_path / "result.json"
    env = dict(os.environ, OMP_NUM_THREADS="1", NESTMC_NUM_PROCESSES="4",
               NESTMC_COORDINATOR_ADDRESS=f"file://{tmp_path}/rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "portbench.tests._tiny",
         "mala-100k.sample.2x2", fault, str(out)], cwd=ROOT,
        env=dict(env, NESTMC_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("fault", ["none", "exchange"])
def test_four_ranks_on_the_cpu_and_the_exchange_left_out(fault, tmp_path):
    r = _sharded(fault, tmp_path)
    assert r["device"]["count"] == 4
    assert r["correct"] is (fault == "none"), r["check"]


def test_no_card_no_result():
    """The measurement path fails without a card: it never falls back to
    the CPU."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "judged.sample",
         "--seed", "2147483999", "--seconds", "10", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if "no CUDA device" not in out.stderr:
        pytest.skip("a card is present")
    assert out.returncode == 3
    assert out.stdout.strip() == ""


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "judged.sample",
         "--seed", "1", "--seconds", "10", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
