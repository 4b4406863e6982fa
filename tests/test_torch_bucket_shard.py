"""A group shard's bucket layout (ops/bucket.py, BucketLayout.shard).

- Each shard's layout is the global one cut to the shard's groups:
  bucket for bucket the same caps, the global bucket's size and the
  shard's place in it as ``units``, ids and observation rows rebased,
  padded data the global rows; the shards' groups make up each global
  bucket, in order, and a bucket may be empty on a shard.
- The bucketed fused steps on a shard's layout give the global call's
  columns of that shard's groups bitwise, and leave the generators where
  the global call leaves them, a shard with an empty bucket too (every
  rank draws the same noise a sweep).
- On the card a skipped bucket draws its launch's Philox key and
  nothing else.

Single process, plain versions on the CPU; the two-rank runs are in
tests/test_torch_sharding.py.
"""

import numpy as np
import pytest
import torch

from nestmc_torch.data import from_numpy_ragged
from nestmc_torch.ops import bucket as tb
from nestmc_torch.ops.cuda.common import skip_step
from nestmc_torch.rng import SweepRNG
from tests._torch_dist_worker import ragged_case
from tests.test_torch_calibration import one_thread  # noqa: F401


def _setup():
    x, y, seg, G = ragged_case()
    data = from_numpy_ragged(x, y, seg, G, device="cpu")
    layout = tb.BucketLayout.build(data.segment_ids, G, x=data.x, y=data.y)
    offsets = np.searchsorted(seg, np.arange(G + 1))
    return data, layout, offsets


def _shards(G, parts):
    return [((i * G) // parts, ((i + 1) * G) // parts) for i in range(parts)]


@pytest.mark.parametrize("parts", [2, 3])
def test_shard_layout_is_the_global_layout_cut(parts):
    data, layout, offsets = _setup()
    cuts = [layout.shard(g0, g1, int(offsets[g0]))
            for g0, g1 in _shards(data.num_groups, parts)]
    empty = 0
    for k, b in enumerate(layout.buckets):
        ids, rows = [], []
        for (g0, _), lay in zip(_shards(data.num_groups, parts), cuts):
            sb = lay.buckets[k]
            assert sb.cap == b.cap
            assert sb.units == (len(ids), b.size)
            empty += sb.size == 0
            a, z = len(ids), len(ids) + sb.size
            ids += (sb.group_index + g0).tolist()
            assert torch.equal(sb.x, b.x[a:z])
            assert torch.equal(sb.y, b.y[a:z])
            assert torch.equal(sb.mask, b.mask[a:z])
            obs = sb.obs_index
            rows.append(np.where(obs >= 0, obs + offsets[g0], -1))
        assert ids == b.group_index.tolist()
        np.testing.assert_array_equal(np.concatenate(rows), b.obs_index)
    assert empty >= 1                     # the case leaves one bucket empty
    for (g0, g1), lay in zip(_shards(data.num_groups, parts), cuts):
        assert lay.num_groups == g1 - g0 and lay.covers_all


def _inputs(C, G, p, seed=3):
    g = torch.Generator().manual_seed(seed)
    T = p * (p + 1) // 2
    h = torch.zeros(C, G, T)
    for i in range(p):
        h[..., i * (i + 1) // 2 + i] = 2.0 + torch.rand(C, G, generator=g)
    return dict(beta=0.3 * torch.randn(C, G, p, generator=g),
                v=-torch.rand(C, G, generator=g),
                g=0.3 * torch.randn(C, G, p, generator=g), h=h,
                ls=0.3 * torch.randn(C, G, generator=g) - 1.0,
                mu=0.3 * torch.randn(C, p, generator=g),
                lt=0.3 * torch.randn(C, p, generator=g) - 0.5)


def _step(name, a, layout, rng, cols=slice(None)):
    t = {k: (v[:, cols].contiguous() if k in ("beta", "v", "g", "h", "ls")
             else v) for k, v in a.items()}
    if name == "mala":
        return tb.bucketed_fused_mala_step(
            t["beta"], t["v"], t["g"], t["ls"], t["mu"], t["lt"], layout,
            rng=rng)
    return tb.bucketed_fused_newton_step(
        t["beta"], t["v"], t["g"], t["h"], t["ls"], t["mu"], t["lt"],
        layout, rng=rng, frozen=name == "newton_frozen")


@pytest.mark.parametrize("name", ["mala", "newton", "newton_frozen"])
def test_shard_steps_are_the_global_call_and_draw_its_noise(name):
    data, layout, offsets = _setup()
    C, G, p = 5, data.num_groups, data.num_covariates
    a = _inputs(C, G, p)
    rng = SweepRNG(7, "cpu")
    full = _step(name, a, layout, rng)
    for g0, g1 in _shards(G, 2):
        lay = layout.shard(g0, g1, int(offsets[g0]))
        srng = SweepRNG(7, "cpu")
        part = _step(name, a, lay, srng, slice(g0, g1))
        for f, q in zip(full, part):
            torch.testing.assert_close(q, f[:, g0:g1], rtol=0, atol=0)
        for k, st in rng.get_state().items():
            assert torch.equal(srng.get_state()[k], st), k


class _KeyCounter:
    def __init__(self):
        self.keys = 0

    def philox_key(self):
        self.keys += 1
        return (1, 2)

    def normal(self, *a, **k):
        raise AssertionError("a skipped launch on the card draws no tensor")

    log_uniform = normal


def test_skip_step_on_the_card_draws_one_key():
    rng = _KeyCounter()
    skip_step(rng, "cuda", (4, 0, 3), (0, 6))
    assert rng.keys == 1
    # on the CPU: the plain version's noise, two unit-axis fills, each
    # taking its key pair whatever its extent
    a, b = SweepRNG(2, "cpu"), SweepRNG(2, "cpu")
    skip_step(a, "cpu", (4, 0, 3), (0, 6))
    b.normal((4, 6, 3), units=(1, 0, 6))
    b.log_uniform((4, 6), units=(1, 0, 6))
    for k, st in b.get_state().items():
        assert torch.equal(a.get_state()[k], st), k
