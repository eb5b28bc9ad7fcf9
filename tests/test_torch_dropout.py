"""Dropout keyed by element (stgcn_tpu_torch.kernels.dropout): the hash, the
mask's independence of tiling and padding, its keep rate, and the masks the
forward kernels' plain versions apply, read back through identity weights."""

import numpy as np
import pytest
import torch

from stgcn_tpu_torch.kernels import dropout as D
from stgcn_tpu_torch.kernels.probes import mask_probes

M32 = 0xFFFFFFFF


def _fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _bits(seed, site, index):
    """The documented hash in plain Python integers."""
    key = _fmix32((seed & M32) ^ _fmix32((site * 0x9E3779B9 + 0x7F4A7C15) & M32))
    return _fmix32(_fmix32((index & M32) ^ key) ^ (((index >> 32) * 0x85EBCA6B) & M32))


@pytest.mark.parametrize("seed,site", [(0, 0), (42, 1), (M32, 7), (123456789, 2)])
def test_bits_equal_the_documented_hash(seed, site):
    rng = np.random.default_rng(seed & 0xFFFF)
    idx = [0, 1, 2, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 40 + 5,
           *rng.integers(0, 2 ** 45, 50).tolist()]
    got = D.bits(seed, site, torch.tensor(idx, dtype=torch.int64)).tolist()
    assert got == [_bits(seed, site, i) for i in idx]


def test_mask_is_independent_of_padding_and_layout():
    drop = D.Drop(0.5, 99, 3)
    b, t, c, v = 3, 5, 7, 150
    narrow = D.keep_mask(drop, (b, t, c, v), v)
    for w in (256, 384):
        wide = D.keep_mask(drop, (b, t, c, w), v)
        assert torch.equal(wide[..., :v], narrow)
        assert float(wide[..., v:].abs().max()) == 0.0     # padded lanes carry nothing
    # a slice of the batch keyed by its own logical indices: the rows of a
    # tile are the rows of the whole, wherever the tile starts
    flat = D.keep_mask(drop, (1, 1, b * t * c, v), v)
    assert torch.equal(flat.reshape(b, t, c, v), narrow)
    # the channels-last (unfused) dropout applies the transposed cv mask
    x = torch.ones(b, t, v, c)
    assert torch.equal(D.apply_channels_last(x, drop), narrow.transpose(2, 3))


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_keep_rate_within_four_sigma(rate):
    drop = D.Drop(rate, D.step_seed(42, 17), 0)
    m = D.keep_mask(drop, (32, 8, 64, 228), 228)
    n = m.numel()
    keep = float((m > 0).float().mean())
    assert abs(keep - (1 - rate)) <= 4 * (rate * (1 - rate) / n) ** 0.5
    assert set(torch.unique(m).tolist()) == {0.0, float(np.float32(1 / (1 - rate)))}


def test_sites_and_steps_draw_different_masks():
    shape = (4, 6, 16, 228)
    base = D.keep_mask(D.Drop(0.5, D.step_seed(42, 0), 0), shape, 228)
    for other in (D.Drop(0.5, D.step_seed(42, 1), 0), D.Drop(0.5, D.step_seed(42, 0), 1),
                  D.Drop(0.5, D.step_seed(43, 0), 0)):
        agree = float((D.keep_mask(other, shape, 228) == base).float().mean())
        assert 0.45 < agree < 0.55


def test_drop_rejects_rates_outside_the_open_interval():
    for rate in (0.0, 1.0, -0.1):
        with pytest.raises(ValueError, match="rate"):
            D.Drop(rate, 1, 0)


@pytest.mark.parametrize("v_true", [150, 228])
def test_probes_read_the_mask_back_exactly(v_true):
    """The probe that reads a kernel's mask on the card, run on the plain
    versions here: each reads back exactly the plain mask."""
    for name, (got, plain) in mask_probes(D.Drop(0.5, 2024, 1), 3, 8, v_true, 256,
                                          "cpu").items():
        assert torch.equal(got, plain), name
