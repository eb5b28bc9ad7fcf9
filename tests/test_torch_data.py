"""The port's data pipeline equals the JAX package's: numpy ``load_vel``
against the pandas one, splits, scaler, windows and padded batches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.data import datasets as jd
from stgcn_tpu_torch.data import datasets as td


def _write_csv(root, name, arr, fmt):
    d = root / name
    d.mkdir()
    header = ",".join(str(i) for i in range(arr.shape[1]))
    np.savetxt(d / "vel.csv", arr, delimiter=",", header=header, comments="", fmt=fmt)


@pytest.mark.parametrize("fmt", ["%.6f", "%.15g", "%d"])
def test_load_vel_matches_pandas(tmp_path, fmt):
    rng = np.random.default_rng(0)
    arr = rng.uniform(0.0, 80.0, size=(40, 7))
    if fmt == "%d":
        arr = np.round(arr)
    _write_csv(tmp_path, "toy", arr, fmt)
    got = td.load_vel("toy", str(tmp_path))
    ref = jd.load_vel("toy", str(tmp_path))
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)


def test_load_vel_17_digits(tmp_path):
    """numpy parses correctly rounded (17 digits round-trip exactly); pandas'
    default C parser trades the last bits for speed on inputs with more than
    15 significant digits, so the two agree to 1e-12 there, not bit for bit."""
    arr = np.random.default_rng(5).uniform(0.0, 80.0, size=(40, 7))
    _write_csv(tmp_path, "long", arr, "%.17g")
    got = td.load_vel("long", str(tmp_path))
    np.testing.assert_array_equal(got, arr)  # round-trips exactly
    np.testing.assert_allclose(got, jd.load_vel("long", str(tmp_path)), rtol=1e-12)


def test_load_vel_single_column(tmp_path):
    _write_csv(tmp_path, "one", np.arange(5.0)[:, None], "%.3f")
    np.testing.assert_array_equal(td.load_vel("one", str(tmp_path)),
                                  jd.load_vel("one", str(tmp_path)))


@pytest.mark.parametrize("n", [100, 1001, 12672])
def test_split_lengths_and_chrono_split(n):
    assert td.split_lengths(n) == jd.split_lengths(n)
    data = np.arange(n * 2.0).reshape(n, 2)
    for got, ref in zip(td.chrono_split(data), jd.chrono_split(data)):
        np.testing.assert_array_equal(got, ref)


def test_zscore_scaler():
    rng = np.random.default_rng(1)
    data = rng.normal(50, 10, size=(60, 5))
    data[:, 2] = 7.0  # constant column: scale 1
    got, ref = td.ZScoreScaler().fit(data), jd.ZScoreScaler().fit(data)
    np.testing.assert_array_equal(got.mean_, ref.mean_)
    np.testing.assert_array_equal(got.scale_, ref.scale_)
    np.testing.assert_array_equal(got.transform(data), ref.transform(data))
    np.testing.assert_array_equal(got.inverse_transform(data), ref.inverse_transform(data))


@pytest.mark.parametrize("n_steps", [0, 14, 15, 16, 200])
def test_window_starts(n_steps):
    np.testing.assert_array_equal(td.window_starts(n_steps, 12, 3),
                                  jd.window_starts(n_steps, 12, 3))


def test_gather_windows():
    rng = np.random.default_rng(2)
    series = rng.standard_normal((60, 9)).astype(np.float32)
    starts = np.array([0, 5, 44, 3], np.int64)
    x, y = td.gather_windows(torch.from_numpy(series), torch.from_numpy(starts), 12, 3)
    xj, yj = jd.gather_windows(jnp.asarray(series), jnp.asarray(starts, jnp.int32), 12, 3)
    assert x.shape == (4, 12, 9, 1) and y.shape == (4, 9)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))


@pytest.mark.parametrize("batch_size", [7, 32, 100])
def test_batches_with_padded_tail(batch_size):
    series = np.random.default_rng(3).standard_normal((80, 4))
    ds = td.ForecastDataset.from_numpy(series, 12, 3, device="cpu")
    jds = jd.ForecastDataset(jnp.asarray(series, jnp.float32), 12, 3)
    assert ds.num_windows == jds.num_windows == 65 and ds.n_vertex == 4
    got, ref = list(ds.batches(batch_size)), list(jds.batches(batch_size))
    assert len(got) == len(ref)
    for (s, nv), (sj, nvj) in zip(got, ref):
        assert nv == nvj and s.shape == (batch_size,)
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ds.series.numpy(), np.asarray(jds.series))


def test_pemsd7_loads_like_the_jax_package():
    vel = td.load_vel("pemsd7-m")
    assert vel.shape == (12672, 228)
    train, _, _ = td.chrono_split(vel)
    jtrain, _, _ = jd.chrono_split(jd.load_vel("pemsd7-m"))
    np.testing.assert_array_equal(train, jtrain)
