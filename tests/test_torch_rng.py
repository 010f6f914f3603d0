"""Port's threefry RNG vs jax.random: bitwise equal keys and draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offline_raytracer_tpu.utils import rng as jax_rng
from offline_raytracer_tpu_torch.utils import rng

torch.set_num_threads(2)


def _keys(seed, ids, samples):
    jk = jax_rng.pixel_sample_keys(jax_rng.render_key(seed),
                                   jnp.asarray(ids), jnp.asarray(samples))
    tk = rng.pixel_sample_keys(rng.render_key(seed), torch.from_numpy(ids),
                               torch.from_numpy(samples))
    return jk, tk


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_render_key_matches_jax(seed):
    want = np.asarray(jax.random.key_data(jax_rng.render_key(seed)))
    np.testing.assert_array_equal(rng.render_key(seed).numpy(), want)


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_pixel_sample_keys_bitwise(seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 1 << 20, 2000).astype(np.int32)
    samples = rs.randint(0, 4096, 2000).astype(np.int32)
    jk, tk = _keys(seed, ids, samples)
    np.testing.assert_array_equal(
        tk.numpy(), np.asarray(jax.random.key_data(jk)).astype(np.int64))


def test_threefry_words_bitwise():
    rs = np.random.RandomState(1)
    w = rs.randint(0, 1 << 32, (4, 3000), dtype=np.uint64).astype(np.uint32)
    want = jax_rng.threefry2x32(*(jnp.asarray(x) for x in w))
    got = rng.threefry2x32(*(torch.from_numpy(x.astype(np.int64)) for x in w))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("tag,n", [(0, 8), (3, 8), (11, 5),
                                   (rng.CAMERA_TAG, 4)])
def test_tagged_uniform_planes_bitwise(tag, n):
    rs = np.random.RandomState(tag % 1000)
    ids = rs.randint(0, 1 << 18, 1500).astype(np.int32)
    jk, tk = _keys(3, ids, np.full(1500, 2, np.int32))
    want = np.asarray(jax_rng.tagged_uniform_planes(jk, tag, n))
    got = rng.tagged_uniform_planes(tk, tag, n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        rng.tagged_uniforms(tk, tag, n).numpy(),
        np.asarray(jax_rng.tagged_uniforms(jk, tag, n)))
