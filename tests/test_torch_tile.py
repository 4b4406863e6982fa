"""The tile plan of the kernels (nestmc_torch/ops/cuda/common.py
::tile_plan, the Python mirror of csrc/cell_tile.cuh::plan_tile): every
shape the presets and the ragged size buckets give fits, every (n, p) that
the 48 KB stage of the one-unit kernels the tile replaced accepted still
fits, no tile asks for more than a block may take, and what cannot fit
raises. On the card, tests/test_torch_cuda.py holds the mirror against the
launchers' own plan.
"""

import pytest

from nestmc_torch.kernel_ab import main as kernel_ab_main
from nestmc_torch.ops.cuda.common import (
    SEG_OBS,
    SMEM_MAX,
    TILE_BLOCKS,
    TILE_C,
    TILE_G_MAX,
    TILE_KINDS,
    SMEM_RESERVED,
    SMEM_SM,
    tile_bytes,
    tile_plan,
)
from nestmc_torch.presets import PRESETS, get_preset


def _budget(kind):
    return SMEM_SM // TILE_BLOCKS[kind] - SMEM_RESERVED


def _check_plan(kind, n, p):
    tg, tc, smem = tile_plan(kind, n, p)
    assert tc == TILE_C == 32
    assert 1 <= tg <= TILE_G_MAX and tg & (tg - 1) == 0
    assert smem == tile_bytes(kind, n, p, tg) <= SMEM_MAX
    # tg is the largest power of two within the kernel's budget, and only
    # one unit may exceed the budget
    assert smem <= _budget(kind) or tg == 1
    if tg < TILE_G_MAX:
        assert tile_bytes(kind, n, p, 2 * tg) > _budget(kind)
    return tg, smem


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_tile_plan_fits_every_preset(name):
    """Each preset's (n, p) (padded data: the unit's n; ragged data: the
    size-bucket caps 8, 16 and 32 of config 4) fits every launch mode."""
    _, data, _ = get_preset(name, device="cpu", groups=8)
    p = data.x.shape[-1]
    ns = (8, 16, 32) if name.startswith("ragged") else (data.x.shape[1],)
    for n in ns:
        for kind in TILE_KINDS:
            _check_plan(kind, n, p)


@pytest.mark.parametrize("kind, n, p, tg, smem", [
    # mala-100k (n=20, p=3): 32 units a tile; the MALA step with Philox
    # noise (its main path) and logp_grad
    ("mala", 20, 3, 32, 46080),
    ("logp_grad", 20, 3, 32, 29440),
    # the judged config (n=50, p=4): 16 units a tile
    ("logp_grad", 50, 4, 16, 29696),
    ("logp_grad_hess", 50, 4, 16, 50304),
    # config 3 (n=10, p=3), the Poisson MALA step with external noise
    ("pois_mala_noise", 10, 3, 16, 34816),
    # the Newton step (3 blocks an SM: 76,800 bytes a block; rows beta, g
    # (p), h (T), v, log_scale (1), + eps (p), log u (1) with external
    # noise, + the per-unit prior mean (p) for Poisson): judged (n=50,
    # p=4, T=10), 16 units: 4800 + 32 (65 + 65 + 161 + 17 + 17) floats
    ("newton", 50, 4, 16, 60800),
    ("newton_noise", 50, 4, 16, 71296),
    # the widest ragged-10k bucket (n=32, p=3, T=6), 16 units: 2560 + 32
    # (49 + 49 + 97 + 17 + 17) floats; 32 units would take 78,464 bytes
    ("newton", 32, 3, 16, 39552),
    ("newton_noise", 32, 3, 16, 48000),
    # config 3 (n=10, p=3): 32 subjects fill the budget exactly, 1600 + 32
    # (97 + 97 + 193 + 33 + 33 + 97) floats; with external noise 16
    ("pois_newton", 10, 3, 32, 76800),
    ("pois_newton_noise", 10, 3, 16, 47232),
    # the segment kernel (5 blocks an SM: 45,670 bytes a block), x and y of
    # a chunk of 32 observations a group, rows gradient (p) and loglik (1):
    # 32 groups, p=3: 4096 + 32 (97 + 33) floats; p=4: 5120 + 32 (129 + 33)
    ("seg", 32, 3, 32, 33024),
    ("seg", 32, 4, 32, 41216),
    # the RW-MH step (4 blocks an SM: 57,344 bytes a block; rows beta (p),
    # the carried loglik, log_scale (1), + eps (p), log u (1) with external
    # noise, + the per-unit prior mean (p) for Poisson): config 3's
    # pois_rwmh_step with Philox noise, 32 subjects, 1600 + 32 (97 + 33 +
    # 33 + 97) floats; mala-100k with external noise, 32 units, 3200 + 32
    # (97 + 33 + 33 + 97 + 33) floats
    ("pois_rwmh", 10, 3, 32, 39680),
    ("rwmh_noise", 20, 3, 32, 50304),
    # the value-only loglik of both families (12 blocks an SM: 18,432 bytes
    # a block; one row, the loglik): config 3's pois_loglik, 32 subjects,
    # 1600 + 32 x 33 floats; mala-100k, 32 units, 3200 + 32 x 33 floats
    ("loglik", 10, 3, 32, 10624),
    ("loglik", 20, 3, 32, 17024),
])
def test_tile_plan_at_the_main_shapes(kind, n, p, tg, smem):
    """The plan at the main paths' shapes, by hand: 4 (x, y, mask of tg
    units, each rounded up to 4 floats, plus 32 rows of odd stride
    (tg w) | 1 a row buffer) bytes."""
    assert tile_plan(kind, n, p) == (tg, 32, smem)
    assert _check_plan(kind, n, p) == (tg, smem)


# the stage of the one-unit kernels the tile replaced: a unit's x, y and
# mask, n (p + 2) floats, within the 48 KB of default dynamic shared memory
# a block may use
ONE_UNIT_STAGE_BYTES = 48 * 1024


@pytest.mark.parametrize("p", range(1, 9))
def test_tile_plan_accepts_what_the_one_unit_stage_accepted(p):
    """Every (n, p) with n (p + 2) floats within 48 KB (the stage of the
    one-unit kernels the tile replaced) fits every tiled launch mode, and
    the unit depth never grows with n."""
    n_max = ONE_UNIT_STAGE_BYTES // (4 * (p + 2))
    assert 4 * n_max * (p + 2) <= ONE_UNIT_STAGE_BYTES
    assert 4 * (n_max + 1) * (p + 2) > ONE_UNIT_STAGE_BYTES
    ns = sorted(set(range(1, 65)) | set(range(65, n_max, 97)) | {n_max})
    for kind in TILE_KINDS:
        last = TILE_G_MAX
        for n in ns:
            tg, _ = _check_plan(kind, n, p)
            assert tg <= last
            last = tg
        assert last >= 1


@pytest.mark.parametrize("kind", TILE_KINDS)
def test_tile_plan_raises_where_no_tile_fits(kind):
    """One unit's data over what a block may take raises; just under it,
    one unit a tile."""
    p = 3
    n = 1
    while tile_bytes(kind, 2 * n, p, 1) <= SMEM_MAX:
        n *= 2
    lo, hi = n, 2 * n                   # fits at lo, not at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if tile_bytes(kind, mid, p, 1) <= SMEM_MAX \
            else (lo, mid)
    assert tile_plan(kind, lo, p)[0] == 1
    with pytest.raises(ValueError, match="shared memory"):
        tile_plan(kind, hi, p)


def test_tile_plan_rejects_unknown_kinds():
    """A launch counter's name is no tile kind: both families' value-only
    passes plan as "loglik"."""
    with pytest.raises(ValueError, match="unknown tiled kernel"):
        tile_plan("pois_loglik", 20, 3)


@pytest.mark.parametrize("kind", ["newton", "newton_noise"])
@pytest.mark.parametrize("n, p", [(50, 4), (32, 3), (16, 3), (8, 3)])
def test_newton_tile_keeps_four_units_at_the_main_shapes(kind, n, p):
    """The judged shape and every ragged-10k size bucket keep at least 4
    units a Newton tile (8 warps on at least 4 units), with the Philox and
    the external noise."""
    assert tile_plan(kind, n, p)[0] >= 4


@pytest.mark.parametrize("p", range(1, 9))
def test_segment_tile_fits_every_p(p):
    """The segment kernel's launcher plans with SEG_OBS observations a
    group of a chunk; it fits for every p the kernels take, at least 4
    groups a tile, and its chunk holds tg SEG_OBS observations."""
    tg, tc, smem = tile_plan("seg", SEG_OBS, p)
    assert tc == 32 and tg >= 4
    assert smem == tile_bytes("seg", SEG_OBS, p, tg)
    # x (tg SEG_OBS p) and y (tg SEG_OBS), no mask, then the two rows
    floats = tg * SEG_OBS * (p + 1) + 32 * (((tg * p) | 1) + (tg | 1))
    assert smem == 4 * floats


def test_warp_idle_share_by_hand():
    """kernel_ab's imbalance count of the segment tile: warp w takes the
    groups w, w + 8, ...; a block lasts as long as its longest warp."""
    from nestmc_torch.kernel_ab import warp_idle_share

    assert warp_idle_share([3] * 16, 8) == 0.0
    # one tile of 8 groups, one busy warp: 8 of 64 warp-slot units busy
    assert warp_idle_share([8, 0, 0, 0, 0, 0, 0, 0], 8) == 1.0 - 8 / 64
    # two tiles of 4 groups (4 warps): loads (4, 2, 2, 0) and (1, 1, 1, 1)
    assert warp_idle_share([4, 2, 2, 0, 1, 1, 1, 1], 4) == \
        1.0 - 12 / (4 * 4 + 4 * 1)


def test_ptxas_report_reads_the_tiled_kernels():
    """kernel_ab's reader of an -Xptxas -v log keeps the tiled templates'
    registers and spills and skips the other kernels (the Philox probe)."""
    from nestmc_torch.kernel_ab import ptxas_report

    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN6nestmc18newton_step_kernelINS_5LogitELi4ELb1ELb1ELb0EEEvNS_"
        "10NewtonArgsEi' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN6nestmc18newton_step",
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill "
        "loads",
        "ptxas info    : Used 80 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN6nestmc13loglik_kernelINS_5LogitELi3EEEvPKfS3_S3_S3_S3_Pfiii'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 30 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN6nestmc19philox_probe_kernelEPfS0_ijj' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 24 registers, used 0 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN6nestmc14segment_kernelILi3ELb1EEEvPKfS2_PKiS2_PfS5_iii' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
    ])
    got = ptxas_report(log)
    assert [r["registers"] for r in got] == [80, 30, 40]
    assert (got[0]["spill_stores"], got[0]["spill_loads"]) == (12, 16)
    assert "loglik_kernel" in got[1]["kernel"]
    assert "segment_kernel" in got[2]["kernel"]


def test_kernel_ab_needs_a_card():
    """The A/B timer fails without a CUDA device instead of timing the
    CPU."""
    assert kernel_ab_main(["--base", "nowhere"]) == 1
