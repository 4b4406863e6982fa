"""Fault injection across processes (twin of tests/test_fault_injection.py):
SIGKILL ``python -m nestmc_torch run`` after a sampling checkpoint, resume
in a new process from the newest complete checkpoint, and check that the
resumed run finishes and reports.

The checkpoint is found with nestmc_torch.checkpoint.latest_tag, which
ranks only a meta whose carry is in place (both are written to a
temporary name and moved, the carry first), never by listing file names:
a listing can catch a meta still being written. Every wait has its own
time limit. Also the port's get_logger (the reference's
nestmc/utils/logging.py): one handler, no propagation, its format.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import time

from nestmc_torch.checkpoint import latest_tag
from nestmc_torch.utils import get_logger

PY = sys.executable
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
RUN = [PY, "-m", "nestmc_torch", "run", "--preset", "eight-schools",
       "--device", "cpu", "--chains", "4", "--warmup", "40", "--draws",
       "3000", "--segment-size", "20"]


def test_kill_and_resume(tmp_path):
    ckdir = str(tmp_path / "ck")
    err = open(tmp_path / "killed.err", "w")
    proc = subprocess.Popen(
        RUN + ["--checkpoint-dir", ckdir, "--checkpoint-every", "1",
               "--quiet"],
        env=ENV, cwd=REPO, stdout=subprocess.DEVNULL, stderr=err)
    try:
        # wait (at most 120 s) for a sampling-phase checkpoint, then kill
        deadline = time.time() + 120
        tag = None
        while time.time() < deadline:
            tag = latest_tag(ckdir)
            if tag is not None and tag.startswith("sample_"):
                break
            assert proc.poll() is None, (
                "the run exited before a sampling checkpoint: "
                + open(tmp_path / "killed.err").read()[-800:])
            time.sleep(0.05)
        assert tag is not None and tag.startswith("sample_"), \
            "no sampling checkpoint within 120 s"
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        err.close()
    assert proc.returncode == -signal.SIGKILL

    tag = latest_tag(ckdir)
    assert tag is not None and tag.startswith("sample_")
    with open(os.path.join(ckdir, f"meta_{tag}.json")) as f:
        done = json.load(f)["draws_done"]
    assert 0 < done < 3000
    r = subprocess.run(
        RUN + ["--checkpoint-dir", ckdir, "--resume", "--quiet",
               "--metric-json"],
        env=ENV, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert f"resuming from {tag}" in r.stderr
    assert f"running the remaining {3000 - done} of 3000" in r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["preset"] == "eight-schools"
    assert res["timings"]["draws_run"] == 3000 - done
    assert res["total_ess"] > 0 and res["worst_rhat"] < 1.1


def test_get_logger_has_one_handler_in_the_reference_format():
    name = "nestmc_torch.test_fault_injection"
    a = get_logger(name)
    b = get_logger(name, logging.WARNING)
    assert a is b and len(a.handlers) == 1
    assert a.propagate is False and a.level == logging.WARNING
    h = a.handlers[0]
    assert h.formatter._fmt == "%(asctime)s %(name)s %(levelname)s %(message)s"
    assert h.formatter.datefmt == "%H:%M:%S"
    assert get_logger().name == "nestmc_torch"
