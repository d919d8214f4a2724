"""Port volume ops (diffusioniqt_tpu_torch/ops/volume.py) against the JAX
package's: split, merge, the plain halo sweep and the 3D pixel
(un)shuffle must be exactly equal (pure data movement)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffusioniqt_tpu.ops import volume as jv
from diffusioniqt_tpu_torch.ops import volume as tv

torch.set_num_threads(1)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,factor", [((2, 12, 12, 12, 3), 3),
                                          ((1, 8, 8, 8, 2), 2)])
def test_split_merge_equal_jax(shape, factor):
    x = _rand(shape)
    want = np.asarray(jv.volume_to_subvolumes(jnp.asarray(x), factor))
    got = tv.volume_to_subvolumes(torch.from_numpy(x), factor).numpy()
    np.testing.assert_array_equal(got, want)
    back = tv.subvolumes_to_volume(torch.from_numpy(got), factor).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(jv.subvolumes_to_volume(jnp.asarray(want), factor)))


@pytest.mark.parametrize("n,s,c,factor", [(27, 4, 3, 3), (54, 3, 2, 3),
                                          (8, 5, 4, 2)])
def test_halo_sweep_equal_jax(n, s, c, factor):
    x = _rand((n, s, s, s, c), seed=1)
    want = np.asarray(jv.halo_exchange(jnp.asarray(x), factor))
    got = tv.halo_exchange(torch.from_numpy(x), factor).numpy()
    np.testing.assert_array_equal(got, want)
    # the gather formulation (the reference's merge -> pad -> unfold) agrees too
    np.testing.assert_array_equal(
        got, np.asarray(jv.boundary_halo(jnp.asarray(x), factor)))


def test_halo_factor_one_is_zero_padding():
    x = _rand((3, 4, 4, 4, 2), seed=2)
    got = tv.halo_exchange(torch.from_numpy(x), 1).numpy()
    np.testing.assert_array_equal(got, np.pad(x, [(0, 0)] + [(1, 1)] * 3 + [(0, 0)]))


@pytest.mark.parametrize("shape", [(2, 3, 3, 3, 16), (1, 2, 4, 2, 8)])
def test_pixel_shuffle_equal_jax(shape):
    x = _rand(shape, seed=3)
    want = np.asarray(jv.pixel_shuffle_3d(jnp.asarray(x), 2))
    got = tv.pixel_shuffle_3d(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tv.pixel_unshuffle_3d(torch.from_numpy(got), 2).numpy(), x)
    np.testing.assert_array_equal(
        tv.pixel_unshuffle_3d(torch.from_numpy(got), 2).numpy(),
        np.asarray(jv.pixel_unshuffle_3d(jnp.asarray(want), 2)))
