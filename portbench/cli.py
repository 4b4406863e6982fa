"""The command line: one run of one cell.

``python3 -m portbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout (where ``BENCHMARK.json``
is). A one-chip cell runs in this process on the first card. A cell on
more chips is launched here: the kernels are built once, then one process
a rank starts on its own card (``--rank``, with the ``NESTMC_*``
variables of the program's multi-process entry and a free localhost
port), each rank's output goes to a file under ``TMPDIR``, and when every
rank has ended their standard error is written out, rank 0's last, then
rank 0's result line. ``--control 1`` puts the control (the reference in
TF32) in the program's place, so that the line's check and ``correct``
are the control's; ``--repeat N`` runs seeds seed .. seed + N - 1 one
after another in the same processes and prints a line for each (the
check's readings over seeds without a process's set-up each; on several
cards the launcher prints the last). The benchmark's own runs leave both
at their defaults.

Exit codes: 0 with a result line; 1 a run that failed; 2 an unusable
checkout (no program, no cell); 3 fewer cards than the cell asks for; 4 a
forbidden module loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

from portbench import harness

RANK_TIMEOUT_S = 1150


def _args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _guard() -> bool:
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"forbidden modules loaded: {bad}; no result")
    return not bad


def _cards(cell) -> int | None:
    """None when the machine holds the cards the cell asks for, else the
    exit code."""
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark runs on the card only")
        return 3
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} present")
        return 3
    return None


def _print_result(result: dict) -> int:
    for k, v in result["check"].items():
        harness.log(f"check {k}: {v['value']:.6g} (limit {v['limit']:g})")
    if not _guard():
        return 4
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None, t_start: float | None = None) -> int:
    import time

    t_start = time.monotonic() if t_start is None else t_start
    a = _args(argv)
    try:
        cell = harness.load_cell(a.workload)
    except (OSError, ImportError, KeyError, ValueError,
            StopIteration) as e:
        harness.log(f"cannot read the cell {a.workload!r}: {e!r}")
        return 2
    try:
        import nestmc_torch  # noqa: F401
    except ImportError as e:
        harness.log(f"the program (nestmc_torch) is not here: {e}")
        return 2
    if a.rank is not None:
        return _rank(cell, a)
    code = _cards(cell)
    if code is not None:
        return code
    if cell.chips > 1:
        return _launch(cell, a, t_start)
    import torch

    torch.cuda.set_device(0)
    for i in range(a.repeat):
        result = harness.run(cell, a.seed + i, a.seconds, bool(a.trace),
                             torch.device("cuda", 0),
                             t_start if i == 0 else time.monotonic(),
                             control=bool(a.control))
        code = _print_result(result)
        if code:
            return code
    return 0


def _rank(cell, a) -> int:
    """One rank of a cell on several cards (started by :func:`_launch`)."""
    from nestmc_torch.parallel import multihost

    import time

    multihost.initialize()
    t_start = float(os.environ["PORTBENCH_T0"])
    code = 0
    for i in range(a.repeat):
        result = harness.run(cell, a.seed + i, a.seconds, bool(a.trace),
                             multihost.device(),
                             t_start if i == 0 else time.monotonic(),
                             control=bool(a.control))
        code = 0 if result is None else _print_result(result)
        if code:
            break
    import torch.distributed as dist

    dist.destroy_process_group()
    return code


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(cell, a, t_start: float) -> int:
    """Build the kernels once, start a process a rank, wait for all of
    them, then write out their output (rank 0's last)."""
    cell.model.prepare(cell.config)
    port = _free_port()
    out = Path(tempfile.mkdtemp(prefix="portbench-ranks-"))
    procs, files = [], []
    try:
        for r in range(cell.chips):
            env = dict(os.environ,
                       NESTMC_COORDINATOR_ADDRESS=f"localhost:{port}",
                       NESTMC_NUM_PROCESSES=str(cell.chips),
                       NESTMC_PROCESS_ID=str(r), PORTBENCH_T0=repr(t_start),
                       OMP_NUM_THREADS="1")
            fo = open(out / f"rank{r}.out", "w")
            fe = open(out / f"rank{r}.err", "w")
            files += [fo, fe]
            cmd = [sys.executable, "-m", "portbench", "--workload",
                   cell.name, "--seed", str(a.seed), "--seconds",
                   str(a.seconds), "--trace", str(a.trace), "--control",
                   str(a.control), "--repeat", str(a.repeat), "--rank",
                   str(r)]
            procs.append(subprocess.Popen(cmd, stdout=fo, stderr=fe,
                                          env=env))
        codes = _wait(procs, RANK_TIMEOUT_S * a.repeat)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    try:
        for r in list(range(1, cell.chips)) + [0]:
            sys.stderr.write((out / f"rank{r}.err").read_text())
        sys.stderr.flush()
        line = (out / "rank0.out").read_text().strip().splitlines()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if any(codes) or not line:
        harness.log(f"rank exit codes {codes}: no result")
        return 1
    if not _guard():
        return 4
    print(line[-1], flush=True)
    return 0


def _wait(procs, seconds: float) -> list:
    """Exit codes of every process; when one fails, or the time runs out,
    the others are ended."""
    import time

    deadline = time.monotonic() + seconds
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            return codes
        if any(c not in (None, 0) for c in codes) or (
                time.monotonic() > deadline):
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            return [p.returncode for p in procs]
        time.sleep(0.2)
