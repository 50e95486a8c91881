"""XLA small-radius motion search vs oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import random_frame
from tpufg.kernels.motion_xla import motion_search_xla
from tpufg.ops import motion_search


def _chw(x):
    return jnp.transpose(x, (2, 0, 1))


def test_bitwise_equal_to_oracle(rng):
    base = random_frame(rng, 32, 48)
    prev = jnp.asarray(base[4:28, 4:44])
    curr = jnp.asarray(base[2:26, 1:41])
    ref = _chw(motion_search(prev, curr, block_size=4, search_radius=4))
    out = motion_search_xla(_chw(prev), _chw(curr), block_size=4,
                            search_radius=4)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_ssd_finds_clean_shift(rng):
    h, w, sx, sy = 24, 24, 3, 2
    base = random_frame(rng, h + 8, w + 8)
    prev = _chw(jnp.asarray(base[4:4 + h, 4:4 + w]))
    curr = _chw(jnp.asarray(base[4 - sy:4 - sy + h, 4 - sx:4 - sx + w]))
    mv = np.asarray(motion_search_xla(prev, curr, 4, 4, metric="ssd"))
    assert np.median(mv[0, 8:-8, 8:-8]) == -sx
    assert np.median(mv[1, 8:-8, 8:-8]) == -sy


def test_tiebreak_constant_pair():
    const = jnp.full((4, 16, 16), 0.3, jnp.float32)
    mv = motion_search_xla(const, const, block_size=4, search_radius=2)
    np.testing.assert_array_equal(np.unique(np.asarray(mv)), [-2.0])


def test_lattice_bitwise_equal_to_tiled_subsample(rng):
    # the per-pixel search (same separable rows-then-x box-sum order)
    # subsampled to the lattice centres
    from tpufg.kernels.motion_xla import motion_search_lattice

    for r in (2, 4):
        base = random_frame(rng, 80, 144)
        prev = _chw(jnp.asarray(base[8:72, 8:136]))
        curr = _chw(jnp.asarray(base[6:70, 11:139]))
        full = motion_search_xla(prev, curr, block_size=8, search_radius=r)
        sub = np.asarray(full[:, 8::16, 8::16])
        lat = np.asarray(motion_search_lattice(prev, curr, grid=16,
                                               block_size=8, search_radius=r))
        np.testing.assert_array_equal(lat, sub)


def test_lattice_rejects_out_of_cell_radius(rng):
    from tpufg.kernels.motion_xla import motion_search_lattice

    x = jnp.zeros((4, 32, 32), jnp.float32)
    with pytest.raises(ValueError):
        motion_search_lattice(x, x, grid=16, block_size=8, search_radius=5)
    with pytest.raises(ValueError):
        motion_search_lattice(x[:, :30, :], x[:, :30, :], grid=16)
