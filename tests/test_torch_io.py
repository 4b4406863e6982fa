"""The port's CSV loader (nestmc_torch/io): the twins of tests/test_io.py's
seven tests, and the port's arrays against nestmc.io.load_csv's on the same
file, native parser and numpy path (equal)."""

import numpy as np
import pytest

from nestmc.io import load_csv as j_load_csv
from nestmc_torch import RunConfig, SamplerConfig, sample
from nestmc_torch.io import load_csv
from nestmc_torch.io.build import native_lib
from nestmc_torch.models import make_hier_logistic
from tests.test_torch_calibration import one_thread  # noqa: F401


def _write_csv(path, G=50, p=3, max_n=20, seed=3):
    rng = np.random.default_rng(seed)
    rows = []
    for g in range(G):
        for _ in range(rng.integers(1, max_n + 1)):
            x = rng.normal(size=p)
            y = float(rng.integers(0, 2))
            rows.append(
                f"{g * 7 + 3},{y}," + ",".join(f"{v:.6f}" for v in x))
    path.write_text("\n".join(rows) + "\n")
    return len(rows), G


def test_native_builds():
    assert native_lib() is not None, "g++ build of the native ingest failed"


def test_native_matches_python(tmp_path):
    f = tmp_path / "d.csv"
    n_rows, G = _write_csv(f)
    a = load_csv(str(f), native=True, device="cpu")
    b = load_csv(str(f), native=False, device="cpu")
    assert a.num_obs == n_rows == b.num_obs
    assert a.num_groups == G == b.num_groups
    np.testing.assert_allclose(a.y.numpy(), b.y.numpy())
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(a.segment_ids.numpy(),
                                  b.segment_ids.numpy())
    np.testing.assert_array_equal(a.offsets.numpy(), b.offsets.numpy())


@pytest.mark.parametrize("native", [True, False])
def test_arrays_equal_reference(tmp_path, native):
    f = tmp_path / "d.csv"
    _write_csv(f, G=30, p=2, max_n=12, seed=8)
    t = load_csv(str(f), native=native, device="cpu")
    j = j_load_csv(str(f), native=native)
    assert t.num_groups == j.num_groups
    np.testing.assert_array_equal(t.y.numpy(), np.asarray(j.y))
    np.testing.assert_array_equal(t.x.numpy(), np.asarray(j.x))
    np.testing.assert_array_equal(t.segment_ids.numpy(),
                                  np.asarray(j.segment_ids))


def test_no_covariates(tmp_path):
    f = tmp_path / "d.csv"
    f.write_text("1,0.5\n1,1.5\n2,2.5\n")
    d = load_csv(str(f), native=True, device="cpu")
    # the port's covariate-free form: an empty (N, 0) x
    assert d.x.shape == (3, 0) and d.num_groups == 2 and d.num_obs == 3
    np.testing.assert_allclose(d.y.numpy(), [0.5, 1.5, 2.5])
    assert load_csv(str(f), native=False, device="cpu").x.shape == (3, 0)


def test_parse_error_reports_line(tmp_path):
    f = tmp_path / "bad.csv"
    f.write_text("1,0.5,1.0\n1,abc,2.0\n")
    with pytest.raises(ValueError, match="line 2"):
        load_csv(str(f), native=True, device="cpu")


def test_ragged_column_count_rejected(tmp_path):
    f = tmp_path / "bad.csv"
    f.write_text("1,0.5,1.0\n1,0.5\n")
    with pytest.raises(ValueError):
        load_csv(str(f), native=True, device="cpu")


def test_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_csv(str(tmp_path / "not_here.csv"), native=True, device="cpu")


def test_end_to_end_sampling_from_csv(tmp_path):
    f = tmp_path / "d.csv"
    _write_csv(f, G=12, p=2, max_n=8)
    data = load_csv(str(f), device="cpu")
    model = make_hier_logistic(data)
    post = sample(model, data, SamplerConfig(run=RunConfig(
        chains=4, warmup=30, draws=30, log_every_segment=False,
        collect={"mu": None},
    )))
    assert np.all(np.isfinite(post.draws["mu"].numpy()))
