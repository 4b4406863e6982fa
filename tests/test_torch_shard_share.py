"""What a rank of a sharded run holds, and the noise fill that lets it.

Two gloo ranks, spawned once (tests/_torch_dist_worker.py, mode 'share'):
a chain-sharded run keeps only the rank's part of its final carry and
acceptance rates (Posterior.final_state, accept_rates), and
parallel.gather_state gives the unsharded run's carry back bit for bit;
its checkpoints, gathered to the primary alone, hold the unsharded run's
arrays bit for bit, and an allocation audit shows that only the primary
ever formed the carry at its global extents, inside that gather; a
group-sharded run's parts have the group span; warmup_then_state's rank
part starts a sampling run as its gathered carry does.

The fill (ops/cuda/philox_fill, plain version on the CPU): a chain slice,
a unit slice and a block of it equal that slice of the whole fill bit for
bit, SweepRNG's unit-axis draws on a shard are the unsharded draws' slice,
and its normals and uniforms pass Kolmogorov-Smirnov tests at n = 1e6.
Its mapping is pinned against an independent scalar Philox-4x32-10 (itself
held to Random123's known answers): element g takes word g & 3 of the call
at counter g >> 2, at every lane, across row edges and from a block that
starts off a quad; the normals' Box-Muller pairs have radii x0^2 + x1^2
exponential with mean 2, and the lanes of a quad are uncorrelated.
"""

import os

import numpy as np
import pytest
import scipy.stats
import torch

from nestmc_torch import sample
from nestmc_torch.checkpoint import latest_tag
from nestmc_torch.ops.cuda.philox_fill import (
    MODES,
    philox_fill_plain,
    philox_words,
)
from nestmc_torch.rng import SweepRNG
from tests._torch_dist_worker import (
    SHARE_C,
    SHARE_G,
    _leaves,
    share_case,
    share_cfg,
    spawn,
)
from tests.test_torch_calibration import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("share")
    return spawn("share", tmp), tmp


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    """The unsharded run of the share mode, with its checkpoints."""
    ck = tmp_path_factory.mktemp("share_unsharded")
    model, data = share_case()
    return sample(model, data, share_cfg(1, 1, str(ck))), ck


def test_final_state_is_the_rank_part(ranks):
    out, _ = ranks
    half = SHARE_C // 2
    for _, sc in out:
        assert sc["chains_final_shape_beta"] == [half, SHARE_G, 3]
        assert sc["chains_final_shape_mu"] == [half, 3]
        assert sc["chains_accept_shape_beta"] == [half, SHARE_G]
        assert sc["groups_final_shape_beta"] == [SHARE_C, SHARE_G // 2, 3]
        assert sc["groups_final_shape_mu"] == [SHARE_C, 3]
        assert sc["part_beta_shape"] == [half, SHARE_G, 3]


def test_gather_state_is_the_unsharded_carry(ranks, unsharded):
    out, _ = ranks
    post, _ = unsharded
    want = dict(_leaves(post.final_state))
    assert len(want) > 5
    for arrays, sc in out:
        for path, t in want.items():
            np.testing.assert_array_equal(arrays[f"chains_final{path}"],
                                          t.numpy(), err_msg=path)
        np.testing.assert_array_equal(arrays["chains_draws_mu"],
                                      post.draws["mu"].numpy())
        for k, v in post.accept_rates.items():
            # a float64 sum over the ranks against float32 mean(): the
            # same value up to float32 rounding
            assert sc[f"chains_accept_mean_{k}"] == pytest.approx(
                float(v.mean()), rel=1e-6), k
    # the group-split parts gathered: the global shapes
    for path, t in want.items():
        assert out[0][0][f"groups_final{path}"].shape == tuple(t.shape)


def test_checkpoints_are_the_unsharded_runs(ranks, unsharded):
    """Every checkpoint the two ranks wrote (the primary alone) holds the
    unsharded run's arrays at the same count, bit for bit, and resume
    finds the same newest one."""
    _, tmp = ranks
    _, ck_u = unsharded
    ck = tmp / "ck"
    names = sorted(os.listdir(ck))
    assert names == sorted(os.listdir(ck_u))
    tags = [n[len("carry_"):-len(".npz")] for n in names
            if n.startswith("carry_")]
    assert len(tags) == 2 + 3          # warmup 3 + 1, draws 3 x 3
    assert latest_tag(str(ck)) == latest_tag(str(ck_u))
    for tag in tags:
        with np.load(ck / f"carry_{tag}.npz") as a, \
                np.load(ck_u / f"carry_{tag}.npz") as b:
            assert a.files == b.files
            for f in a.files:
                np.testing.assert_array_equal(a[f], b[f], err_msg=(tag, f))


def test_only_the_primary_held_the_carry_whole(ranks):
    """The audit covers the whole run, its five checkpoints included: the
    second rank never made a tensor with both the global chain and group
    extents; the primary made them only inside the gather of a checkpoint
    to it."""
    out, _ = ranks
    a0, a1 = out[0][1]["audit"], out[1][1]["audit"]
    for a in (a0, a1):
        assert a["ops"] > 100
    assert a1["n_global"] == 0, a1["outside"]
    assert a0["outside"] == [] and a0["n_inside"] > 0


def test_a_rank_part_resumes_as_the_global_carry(ranks):
    out, _ = ranks
    for arrays, _ in out:
        np.testing.assert_array_equal(arrays["resume_part_mu"],
                                      arrays["resume_whole_mu"])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fill_slices_are_slices_of_the_whole(mode):
    key = torch.tensor([-123456789, 987654321], dtype=torch.int32)
    C, U = 9, 11
    whole = philox_fill_plain((C, U, 3), key, 0, 0, U, mode)
    assert whole.shape == (C, U, 3)
    chains = philox_fill_plain((4, U, 3), key, 5, 0, U, mode)
    assert torch.equal(chains, whole[5:9])
    units = philox_fill_plain((C, 6, 3), key, 0, 3, U, mode)
    assert torch.equal(units, whole[:, 3:9])
    block = philox_fill_plain((2, 5, 3), key, 1, 6, U, mode)
    assert torch.equal(block, whole[1:3, 6:11])
    # no trailing dims: (C, U)
    flat = philox_fill_plain((C, U), key, 0, 0, U, mode)
    assert torch.equal(philox_fill_plain((C, 4), key, 0, 7, U, mode),
                       flat[:, 7:])


def test_sweep_rng_fill_is_the_unsharded_draws_slice():
    """SweepRNG's unit-axis draws on a rank holding chains 3.. and units
    2..6 of (8, 9, 2) are the unsharded draws' block; both take one key
    pair a draw, so the generators stay equal."""
    whole, part = SweepRNG(4, "cpu"), SweepRNG(4, "cpu")
    part.chains = (3, 8)
    for _ in range(2):
        n = whole.normal((8, 9, 2), units=(1, 0, None))
        lu = whole.log_uniform((8, 9), units=(1, 0, None))
        assert torch.equal(part.normal((5, 4, 2), units=(1, 2, 9)),
                           n[3:, 2:6])
        assert torch.equal(part.log_uniform((5, 4), units=(1, 2, 9)),
                           lu[3:, 2:6])
    for k, st in whole.get_state().items():
        assert torch.equal(part.get_state()[k], st), k


_M32 = 0xFFFFFFFF


def _philox_scalar(ctr, key):
    """Philox-4x32-10 (Salmon et al. 2011) on Python ints, written from the
    paper's round function: hi(M0 x0) ^ x1 ^ k0, lo(M1 x2), hi(M1 x2)...
    with the Weyl key bumps; an independent reference for the port's."""
    x0, x1, x2, x3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * x0, 0xCD9E8D57 * x2
        x0, x1, x2, x3 = (((p1 >> 32) ^ x1 ^ k0) & _M32, p1 & _M32,
                          ((p0 >> 32) ^ x3 ^ k1) & _M32, p0 & _M32)
        k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
    return x0, x1, x2, x3


# Random123's known answers for philox4x32 with 10 rounds (kat_vectors):
# (counter, key, output)
_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_M32,) * 4, (_M32, _M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", _KAT)
def test_philox_round_function_gives_random123s_known_answers(ctr, key, want):
    assert _philox_scalar(ctr, key) == want
    if ctr[2:] == (0, 0):     # philox_words takes counters (g lo, g hi, 0, 0)
        g = torch.tensor([ctr[0] | ctr[1] << 32], dtype=torch.int64)
        got = tuple(int(w[0]) for w in philox_words(g, *key))
        assert got == want


def _unit_f32(word: int) -> float:
    """bits_to_unit: (b >> 8) 2^-24 + 2^-25 rounded once to float32."""
    return float(np.float32((word >> 8) * 2.0 ** -24 + 2.0 ** -25))


def _element(g: int, key, mode: str) -> float:
    """Element g of the fill from the scalar Philox: word g & 3 of the
    call at counter (g >> 2 mod 2^32, g >> 34, 0, 0)."""
    q, lane = g >> 2, g & 3
    w = _philox_scalar((q & _M32, q >> 32, 0, 0), key)
    if mode == "words":
        return float(np.uint32(w[lane]).view(np.int32))
    if mode == "uniform":
        return _unit_f32(w[lane])
    if mode == "log_uniform":
        return float(np.float32(np.log(np.float64(_unit_f32(w[lane])))))
    pair = 2 * (lane // 2)
    r = np.sqrt(-2.0 * np.log(np.float64(_unit_f32(w[pair]))))
    t = 2.0 * np.pi * np.float64(_unit_f32(w[pair + 1]))
    return float(np.float32(r * (np.cos(t) if lane % 2 == 0 else np.sin(t))))


# (shape, c0, u0, U): the whole of a (2, 3) K=1 fill, whose quads straddle
# its rows; a K=3 block of chains 1.. and units 2..6 of 7 (base 27, a
# quad's lane 3; rows 21 elements apart start at lanes 3, 0, 1); a block
# near 2^36 elements (the counter's high words 3 and 5)
_MAP_CASES = [((2, 3), 0, 0, 3), ((3, 5, 3), 1, 2, 7),
              ((2, 6), 1, 2 ** 35 - 9, 2 ** 35)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fill_maps_each_element_to_its_quads_lane(mode):
    key = torch.tensor([-123456789, 987654321], dtype=torch.int32)
    kw = tuple(int(w) & _M32 for w in key.tolist())
    lanes = set()
    for shape, c0, u0, U in _MAP_CASES:
        out = philox_fill_plain(shape, key, c0, u0, U, mode)
        K = int(np.prod(shape[2:], dtype=np.int64))
        base, stride = (c0 * U + u0) * K, U * K
        flat = out.reshape(shape[0], -1)
        for r in range(shape[0]):
            for j in range(flat.shape[1]):
                g = base + r * stride + j
                lanes.add(g & 3)
                want = _element(g, kw, mode)
                got = float(flat[r, j])
                if mode in ("words", "uniform"):
                    assert got == want, (shape, r, j)
                else:   # float64 libm against torch's: one float32 ulp
                    assert abs(got - want) <= abs(float(np.spacing(
                        np.float32(want)))), (shape, r, j, got, want)
    assert lanes == {0, 1, 2, 3}


def test_normal_pairs_have_exponential_radii_at_a_million():
    """x0^2 + x1^2 and x2^2 + x3^2 of a quad's normals are -2 log u1:
    exponential with mean 2 (KS), for each pair of the 250,000 quads."""
    key = torch.tensor([77, -99], dtype=torch.int32)
    x = philox_fill_plain((1000, 1000), key, 0, 0, 1000,
                          "normal").double().reshape(-1, 4).numpy()
    for a in (0, 2):
        r2 = x[:, a] ** 2 + x[:, a + 1] ** 2
        p = scipy.stats.kstest(r2, scipy.stats.expon(scale=2.0).cdf).pvalue
        assert p > 1e-3, (a, p)


@pytest.mark.parametrize("mode", ["normal", "uniform"])
def test_lanes_of_a_quad_are_uncorrelated_at_a_million(mode):
    """The four lanes of 250,000 quads, and for normals their squares
    (a shared radius or angle shows there): every correlation between two
    lanes within 4 / sqrt(n)."""
    key = torch.tensor([31337, 4242], dtype=torch.int32)
    x = philox_fill_plain((1000, 1000), key, 0, 0, 1000,
                          mode).double().reshape(-1, 4).numpy()
    bound = 4.0 / np.sqrt(x.shape[0])
    for v in ((x, x ** 2) if mode == "normal" else (x,)):
        rho = np.corrcoef(v, rowvar=False)
        off = np.abs(rho[~np.eye(4, dtype=bool)])
        assert off.max() < bound, (rho, bound)


@pytest.mark.parametrize("mode", ["normal", "uniform"])
def test_fill_passes_ks_at_a_million(mode):
    key = torch.tensor([2024, 1018], dtype=torch.int32)
    x = philox_fill_plain((1000, 1000), key, 0, 0, 1000, mode).double()
    x = x.reshape(-1).numpy()
    dist = "norm" if mode == "normal" else "uniform"
    p = scipy.stats.kstest(x, dist).pvalue
    assert p > 1e-3, p
    if mode == "uniform":
        assert x.min() > 0.0 and x.max() < 1.0
