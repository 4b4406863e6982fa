"""nestmc_torch.prof at a tiny size on the CPU: both phases report every
field, and the per-block times cover each block of the sweep."""

import json

from nestmc_torch import prof


def test_profile_reports_both_phases(tmp_path, capsys):
    out = tmp_path / "tables.txt"
    assert prof.main(["--device", "cpu", "--chains", "4", "--groups", "3",
                      "--sweeps", "2", "--repeats", "1",
                      "--out", str(out)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for phase in ("warmup", "sampling"):
        r = report[phase]
        assert len(r["wall_ms"]) == 1 and r["wall_ms"][0] > 0
        assert r["device_busy_ms"] is None and r["idle_share"] is None
        assert set(r["block_ms"]) == {
            "newton beta", "gibbs mu", "gibbs log_tau", "move asis_tau"}
        assert any("asis_tau_move" in k for k in r["host_top"])
    assert "== sampling ==" in out.read_text()


def test_profile_covers_the_nested_poisson_blocks(capsys):
    """Config 3's preset: every Gibbs draw, the fused subject step and both
    interweaving moves get a per-block time."""
    assert prof.main(["--preset", "nested-poisson-1k", "--device", "cpu",
                      "--chains", "4", "--groups", "3", "--sweeps", "2",
                      "--repeats", "1"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["G"] == 3 and report["chains"] == 4
    for phase in ("warmup", "sampling"):
        assert set(report[phase]["block_ms"]) == {
            "rwmh beta_s", "gibbs beta_g", "gibbs mu", "gibbs log_tau_g",
            "gibbs log_tau_s", "move asis_tau_g", "move asis_tau_s"}


def test_profile_runs_config_4_on_both_routes(capsys):
    """Config 4's preset on small ragged data: N and the largest group's
    size are reported (not x's second axis, which is p on flat data); the
    bucket route times the fused Newton step, the segment route the
    carried-cache obs passes of the unfused MALA update."""
    for preset, impl, blocks in (
        ("ragged-10k", "auto", {"newton beta", "gibbs mu", "gibbs log_tau",
                                "move asis_tau"}),
        ("ragged-10k-mala", "pallas-segment",
         {"lik beta", "prior beta", "gibbs mu", "cond log_tau",
          "move asis_tau"}),
    ):
        assert prof.main(["--preset", preset, "--loglik-impl", impl,
                          "--device", "cpu", "--chains", "4", "--groups",
                          "40", "--sweeps", "2", "--repeats", "1"]) == 0
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert report["G"] == 40 and report["p"] == 3
        assert report["loglik_impl"] == ("bucket" if impl == "auto"
                                         else impl)
        assert 5 <= report["n"] <= 30 and 200 <= report["N"] <= 1200
        for phase in ("warmup", "sampling"):
            assert set(report[phase]["block_ms"]) == blocks
