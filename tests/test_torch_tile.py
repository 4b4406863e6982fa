"""The tile plan of the coalesced kernels (nestmc_torch/ops/cuda/common.py
::tile_plan, the Python mirror of csrc/cell_tile.cuh::plan_tile): every
shape the presets and the ragged size buckets give fits, every (n, p) the
one-unit kernels' 48 KB stage accepts still fits, no tile asks for more
than a block may take, and what cannot fit raises. On the card,
tests/test_torch_cuda.py holds the mirror against the launchers' own plan.
"""

import pytest

from nestmc_torch.kernel_ab import main as kernel_ab_main
from nestmc_torch.ops.cuda.common import (
    SMEM_MAX,
    TILE_BLOCKS,
    TILE_C,
    TILE_G_MAX,
    TILE_KINDS,
    SMEM_RESERVED,
    SMEM_SM,
    check_smem,
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
])
def test_tile_plan_at_the_main_shapes(kind, n, p, tg, smem):
    """The plan at the main paths' shapes, by hand: 4 (x, y, mask of tg
    units, each rounded up to 4 floats, plus 32 rows of odd stride
    (tg w) | 1 a row buffer) bytes."""
    assert tile_plan(kind, n, p) == (tg, 32, smem)
    assert _check_plan(kind, n, p) == (tg, smem)


@pytest.mark.parametrize("p", range(1, 9))
def test_tile_plan_accepts_what_the_one_unit_stage_accepted(p):
    """Every (n, p) with n (p + 2) floats within 48 KB (common.check_smem,
    the stage of the one-unit kernels) fits every tiled launch mode, and
    the unit depth never grows with n."""
    n_max = 48 * 1024 // (4 * (p + 2))
    check_smem(n_max, p)
    with pytest.raises(ValueError):
        check_smem(n_max + 1, p)
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
    with pytest.raises(ValueError, match="unknown tiled kernel"):
        tile_plan("loglik", 20, 3)


def test_kernel_ab_needs_a_card():
    """The A/B timer fails without a CUDA device instead of timing the
    CPU."""
    assert kernel_ab_main(["--base", "nowhere"]) == 1
