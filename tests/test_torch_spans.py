"""The device-timed spans of the draw step (utils/profiling.span, Spans),
on the CPU at tiny sizes: there the stamps are the host's clock.

- Each route's draw step records the spans its model's blocks and joint
  moves name, under the step's own spans, with their parents and roles:
  the judged path's Newton step, config 3's seven blocks and moves,
  config 4 on the bucket and the segment routes, and config 5's MALA.
- The arithmetic: a span's self time is its time less its children's,
  and the self times of the five roles sum to the step; a span opened
  right after its sibling closed shares its mark; a step that makes more
  marks than the stamp table holds raises.
- ``spans=False`` changes nothing: the same draws, carry and launches
  bit for bit as with spans on, no recorder made, nothing armed, and no
  spans in ``timings`` or on the Posterior.
- A trace gets the spans as a track of their own on the profiler's clock
  (add_track), and ``run --profile DIR --metric-json`` prints them and
  writes the track.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from nestmc_torch import cli, sample
from nestmc_torch.ops.cuda import LAUNCHES, reset_launch_counts
from nestmc_torch.presets import get_preset
from nestmc_torch.rng import SweepRNG
from nestmc_torch.utils import profiling
from nestmc_torch.utils.profiling import (
    SLOTS_PER_STEP,
    SLOTS_PER_SWEEP,
    Spans,
    add_track,
    span,
    span_role,
    trace,
    trace_path,
)
from tests.test_torch_calibration import one_thread  # noqa: F401

STEP = {"step": None, "sweep": "step", "step.collect": "step",
        "step.copy_back": "step"}
# (preset, obs-pass route, groups, {block or move: role})
ROLES = {"unit block", "population block", "joint move", "copy back",
         "rest"}
ROUTES = {
    "judged": ("judged", "auto", 3, {
        "block.beta": "unit block", "block.mu": "population block",
        "block.log_tau": "population block",
        "move.asis_tau": "joint move"}),
    "nested-poisson-1k": ("nested-poisson-1k", "auto", 3, {
        "block.beta_s": "unit block", "block.beta_g": "unit block",
        "block.mu": "population block",
        "block.log_tau_g": "population block",
        "block.log_tau_s": "population block",
        "move.asis_tau_g": "joint move", "move.asis_tau_s": "joint move"}),
    "ragged-10k-bucket": ("ragged-10k", "auto", 40, {
        "block.beta": "unit block", "block.mu": "population block",
        "block.log_tau": "population block",
        "move.asis_tau": "joint move"}),
    "ragged-10k-mala-segment": ("ragged-10k-mala", "pallas-segment", 40, {
        "block.beta": "unit block", "block.mu": "population block",
        "block.log_tau": "population block",
        "move.asis_tau": "joint move"}),
    "mala-100k": ("mala-100k", "auto", 3, {
        "block.beta": "unit block", "block.mu": "population block",
        "block.log_tau": "population block",
        "move.asis_tau": "joint move"}),
}


def _run(preset, impl="auto", groups=3, draws=6, spans=True, seed=3,
         **run):
    model, data, cfg = get_preset(preset, device="cpu", groups=groups,
                                  loglik_impl=impl)
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, chains=4, warmup=4, draws=draws, segment_size=4,
        log_every_segment=False, **run))
    reset_launch_counts()
    rng = SweepRNG(seed, "cpu")
    post = sample(model, data, cfg, rng=rng, spans=spans)
    return model, post, dict(LAUNCHES), rng


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_each_route_records_its_model_spans(route):
    """The span names of a route's draw step are the step's own and one
    a block and a joint move of the model, each with its parent and role;
    every span was read on every sweep, and the step is the longest."""
    preset, impl, groups, blocks = ROUTES[route]
    model, post, _, _ = _run(preset, impl, groups, draws=16)
    spans = post.timings["spans"]
    want = dict(STEP)
    want.update(dict.fromkeys(blocks, "sweep"))
    if post.config["run"]["full_rhat"]:
        want["step.rhat_update"] = "step"
    assert {k: v["parent"] for k, v in spans.items()} == want
    for name, s in spans.items():
        assert s["role"] == blocks.get(name, span_role(name,
                                                       model.unit_axes))
        assert s["sweeps"] == post.timings["draws_run"]
        assert 0 <= s["median_ms"] <= s["p90_ms"]
        assert s["mean_ms"] <= spans["step"]["mean_ms"]
    assert post.timings["spans_clock"]["uncertainty_ns"] >= 0


def test_rhat_update_span_on_the_draws_that_update():
    """With full_rhat_thin = 2 the streamed update runs on every other
    draw only (a step variant of its own): its span is averaged over
    every sweep, counting 0 where the step lacks it."""
    _, post, _, _ = _run("judged", draws=8, full_rhat=True,
                         full_rhat_thin=2)
    spans = post.timings["spans"]
    assert spans["step.rhat_update"]["parent"] == "step"
    assert spans["step.rhat_update"]["median_ms"] >= 0.0
    assert 0.0 < spans["step.rhat_update"]["mean_ms"]


def _by_role(spans: dict) -> dict:
    out = dict.fromkeys(ROLES, 0.0)
    for v in spans.values():
        out[v["role"]] += v["self_ms"]
    return out


def test_self_times_and_groups_tile_the_step():
    """A span's self time is its time less its children's; the self times
    of the five roles sum to the step's mean."""
    _, post, _, _ = _run("judged", draws=8)
    s = post.timings["spans"]
    kids = {n: [k for k, v in s.items() if v["parent"] == n] for n in s}
    for name, v in s.items():
        assert v["self_ms"] == pytest.approx(
            v["mean_ms"] - sum(s[k]["mean_ms"] for k in kids[name]),
            rel=1e-9, abs=1e-9)
    roles = _by_role(s)
    assert sum(roles.values()) == pytest.approx(s["step"]["mean_ms"],
                                                rel=1e-9)
    assert roles["copy back"] == s["step.copy_back"]["mean_ms"]
    assert roles["joint move"] == s["move.asis_tau"]["mean_ms"]
    assert roles["unit block"] == s["block.beta"]["mean_ms"]


def test_a_step_past_the_table_width_raises():
    """The stamp table is allocated at its full width when the recorder is
    made (SLOTS_PER_SWEEP a sweep, SLOTS_PER_STEP more); a step that makes
    more marks raises and disarms the recorder."""
    rec = Spans("cpu", 2, 1, torch.tensor([0]))
    assert rec.table.shape == (2, SLOTS_PER_SWEEP + SLOTS_PER_STEP)
    with pytest.raises(RuntimeError, match="span marks"):
        with profiling.recording(rec, "v"):
            with span("step"):
                for i in range(rec.width):
                    with span(f"block.{i}"):
                        pass
    assert profiling.RECORDER is None


def test_marks_are_shared_at_sibling_boundaries(monkeypatch):
    """A recorder driven by hand on a clock that ticks 10 ns a reading:
    siblings share the mark between them, a parent's entry and exit mark
    apart from its children's, each record holds its name, parent, sweep,
    slots and counts, and the row is the step counter's; a span that a
    step's variant lacks counts 0 in that step's summary."""
    ticks = iter(range(10, 10_000, 10))
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(ticks))
    counter = torch.tensor([0])
    rec = Spans("cpu", 3, 1, counter)
    with profiling.recording(rec, "w"):
        with span("step"):
            pass
    counter[0] = 1
    with profiling.recording(rec, "v"):
        with span("step"):
            with span("sweep"):
                with span("block.a"):
                    LAUNCHES["loglik"] += 2
                with span("block.b"):
                    pass
            with span("step.copy_back"):
                pass
    recs = rec.layouts["v"]
    assert [(r.name, r.parent, r.sweep, r.start, r.end) for r in recs] == [
        ("step", None, None, 0, 7), ("sweep", 0, 0, 1, 5),
        ("block.a", 1, 0, 2, 3), ("block.b", 1, 0, 3, 4),
        ("step.copy_back", 0, None, 5, 6)]
    assert recs[2].launches == 2 and recs[3].launches == 0
    assert recs[0].launches == 2 and recs[0].groups_sum == 0
    LAUNCHES["loglik"] -= 2
    assert rec.slots == {"w": 2, "v": 8}
    assert rec.table.shape == (3, rec.width)
    row = rec.table[1, :8].clone()
    first = rec.table[0, :2].tolist()
    assert first[1] - first[0] == 10
    assert bool((row > first[1]).all()) and bool((row.diff() > 0).all())
    assert not bool(rec.table[1, 8:].any()) and not bool(rec.table[2].any())
    rec.read(["w", "v"])
    assert rec.segments[0][1][1, :8].tolist() == row.tolist()
    assert not bool(rec.table.any())
    out = rec.summary({"a": "groups"}, 1)
    assert out["step"]["mean_ms"] == pytest.approx((10 + 70) / 2 * 1e-6)
    assert out["step"]["median_ms"] == pytest.approx(40 * 1e-6)
    assert out["sweep"]["self_ms"] == pytest.approx(20 / 2 * 1e-6)
    assert out["block.a"]["role"] == "unit block"
    assert out["block.a"]["launches"] == 1.0
    assert profiling.RECORDER is None


def test_spans_off_changes_nothing(monkeypatch):
    """spans=False against spans=True from the same seed: the same draws,
    streamed R-hat, carry, accept rates, launches and generator states
    bit for bit; off, no recorder is made, nothing is armed, and neither
    timings nor the Posterior hold spans."""
    _, on, on_launch, on_rng = _run("judged", draws=6, spans=True)
    made = []
    orig = Spans.__init__

    def counted(self, *a, **k):
        made.append(1)
        orig(self, *a, **k)

    monkeypatch.setattr(Spans, "__init__", counted)
    armed = []
    real_span = profiling.span

    def watch(name):
        armed.append(profiling.RECORDER)
        return real_span(name)

    monkeypatch.setattr(profiling, "span", watch)
    _, off, off_launch, off_rng = _run("judged", draws=6, spans=False)
    assert not made and profiling.RECORDER is None
    assert "spans" not in off.timings and "spans_clock" not in off.timings
    assert off.spans is None and isinstance(on.spans, Spans)
    assert on_launch == off_launch
    for k in on.draws:
        assert torch.equal(on.draws[k], off.draws[k]), k
    for k in on.full_rhat:
        assert torch.equal(on.full_rhat[k], off.full_rhat[k]), k
    for k, v in on.final_state.position.items():
        assert torch.equal(off.final_state.position[k], v), k
    for k, v in on.accept_rates.items():
        assert torch.equal(off.accept_rates[k], v), k
    for a, b in zip(on_rng.get_state().values(),
                    off_rng.get_state().values()):
        assert torch.equal(a, b)


def test_trace_holds_the_spans_track(tmp_path):
    """A run under trace(), then add_track of its Posterior's spans: the
    written Chrome trace holds the recorded spans as a track of their own,
    each inside the host span of the segment it ran in (the same clock),
    besides the host-only spans."""
    model, data, cfg = get_preset("judged", device="cpu", groups=3)
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, chains=4, warmup=2, draws=4, segment_size=2,
        log_every_segment=False))
    with trace(str(tmp_path), "run"):
        post = sample(model, data, cfg, spans=True)
    add_track(trace_path(str(tmp_path), "run"), post.spans.events())
    with open(trace_path(str(tmp_path), "run")) as f:
        events = json.load(f)["traceEvents"]
    track = [e for e in events if e.get("pid") == "nestmc spans (device)"
             and e.get("ph") == "X"]
    names = {e["name"] for e in track}
    assert {"nestmc." + k for k in post.timings["spans"]} == names
    assert len([e for e in track if e["name"] == "nestmc.step"]) == 4
    host = {e["name"]: e for e in events if e.get("ph") == "X"
            and e.get("pid") != "nestmc spans (device)"}
    for k in ("nestmc.segment.tables", "nestmc.finalize",
              "nestmc.sample.seg0", "nestmc.sample.seg1"):
        assert k in host, k
    segs = [host["nestmc.sample.seg0"], host["nestmc.sample.seg1"]]
    lo = min(s["ts"] for s in segs)
    hi = max(s["ts"] + s["dur"] for s in segs)
    for e in track:
        assert lo - 50 <= e["ts"] and e["ts"] + e["dur"] <= hi + 50


def test_cli_profile_prints_the_spans(tmp_path, capsys):
    """``run --profile DIR --metric-json``: the metric line's timings hold
    each span's ms a sweep and the clock's offset, and DIR the trace with
    the spans' track."""
    rc = cli.main(["run", "--preset", "judged", "--device", "cpu",
                   "--scale", "0.002", "--chains", "4", "--warmup", "2",
                   "--draws", "4", "--quiet",
                   "--profile", str(tmp_path / "p"), "--metric-json"])
    out = capsys.readouterr().out
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    spans = line["timings"]["spans"]
    assert {"step", "sweep", "block.beta", "move.asis_tau",
            "step.copy_back"} <= set(spans)
    assert sum(_by_role(spans).values()) == pytest.approx(
        spans["step"]["mean_ms"], rel=1e-9)
    assert "offset_ns" in line["timings"]["spans_clock"]
    with open(trace_path(str(tmp_path / "p"), "judged")) as f:
        events = json.load(f)["traceEvents"]
    assert {e["name"] for e in events if e.get("ph") == "X" and e.get(
        "pid") == "nestmc spans (device)"} == {"nestmc." + k for k in spans}


def test_mark_on_the_cpu_is_the_host_clock():
    """clock_offset on the CPU: the perf counter's offset from Unix time,
    within its uncertainty of a reading taken here."""
    import time

    c = profiling.clock_offset("cpu")
    now = time.time_ns() - time.perf_counter_ns()
    assert abs(c["offset_ns"] - now) < 1e6 + c["uncertainty_ns"]
    assert np.isfinite(c["uncertainty_ns"])


def test_spans_ab_on_the_cpu(tmp_path, capsys):
    """``python -m nestmc_torch.spans_ab`` at a tiny size: a device line,
    a split line a seed whose roles sum to the step and whose steps lie
    inside the call's sample_s, an alt line a call (spans on, then off)
    and the cost line, also appended to --out."""
    from nestmc_torch import spans_ab

    out = tmp_path / "spans.jsonl"
    assert spans_ab.main([
        "--preset", "judged", "--device", "cpu", "--scale", "0.002",
        "--groups", "3", "--seeds", "1,2", "--draws", "4", "--segment",
        "2", "--pairs", "1", "--pair-draws", "2", "--out", str(out)]) == 0
    lines = [json.loads(t) for t in capsys.readouterr().out.splitlines()]
    assert [ln.get("kind") for ln in lines] == [
        None, "split", "split", "alt", "alt", "cost"]
    assert lines == [json.loads(t) for t in out.read_text().splitlines()]
    for ln in lines[1:3]:
        assert sum(ln["roles"].values()) == pytest.approx(ln["step_ms"],
                                                          rel=1e-9)
        assert 0 < ln["coverage"] <= 1
        assert ln["spans"]["move.asis_tau"]["role"] == "joint move"
    assert [ln["spans"] for ln in lines[3:5]] == [True, False]
    assert "block.beta" in lines[3]["span_ms"]
    assert lines[5]["ratio"] == pytest.approx(
        lines[5]["on_ms"] / lines[5]["off_ms"])
