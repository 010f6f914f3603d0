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


@pytest.mark.parametrize("tag_lo,n_tags,n", [(0, 8, 8), (5, 3, 7),
                                             (11, 1, 1), (3, 2, 0),
                                             (rng.CAMERA_TAG, 1, 4),
                                             (rng.CAMERA_TAG - 1, 2, 3)])
def test_uniform_planes_bitwise(tag_lo, n_tags, n):
    """One multi-tag call equals the per-tag planes stacked, and the JAX
    package's draws, bit for bit (n odd and n = 0 included)."""
    rs = np.random.RandomState(n_tags * 100 + n)
    ids = rs.randint(0, 1 << 18, 777).astype(np.int32)
    jk, tk = _keys(9, ids, np.full(777, 4, np.int32))
    got = rng.uniform_planes(tk, tag_lo, n_tags, n)
    assert got.dtype == torch.float32 and got.shape == (n_tags * n, 777)
    if n == 0:
        return
    stacked = torch.cat([rng.tagged_uniform_planes(tk, tag_lo + i, n)
                         for i in range(n_tags)])
    assert torch.equal(got, stacked)
    want = np.concatenate([np.asarray(jax_rng.tagged_uniform_planes(
        jk, tag_lo + i, n)) for i in range(n_tags)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("keys,n_tags,n", [
    (torch.zeros((4, 2), dtype=torch.int32), 1, 8),
    (torch.zeros((4, 2), dtype=torch.float32), 1, 8),
    (torch.zeros((4, 3), dtype=torch.int64), 1, 8),
    (torch.zeros((4,), dtype=torch.int64), 1, 8),
    (torch.zeros((4, 2), dtype=torch.int64), 1, -1),
    (torch.zeros((4, 2), dtype=torch.int64), -1, 8),
])
def test_uniform_planes_bad_input_raises(keys, n_tags, n):
    with pytest.raises(ValueError):
        rng.uniform_planes(keys, 0, n_tags, n)


def test_cuda_routes_refuse_cpu_tensors():
    keys = torch.zeros((4, 2), dtype=torch.int64)
    ids = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        rng.uniform_planes_cuda(keys, 0, 1, 8)
    with pytest.raises(ValueError):
        rng.pixel_sample_keys_cuda(rng.render_key(1), ids, ids)


def test_cpu_takes_plain_route():
    """CPU tensors draw in the plain version: every key and plane is the
    plain version's, and ``KERNEL_LAUNCHES`` does not move."""
    ids = torch.arange(300, dtype=torch.int32)
    smp = torch.full_like(ids, 2)
    root = rng.render_key(5)
    before = rng.KERNEL_LAUNCHES
    keys = rng.pixel_sample_keys(root, ids, smp)
    assert torch.equal(keys, rng.pixel_sample_keys_plain(root, ids, smp))
    plain = rng.uniform_planes_plain
    assert torch.equal(rng.uniform_planes(keys, 0, 3, 8),
                       plain(keys, 0, 3, 8))
    assert torch.equal(rng.tagged_uniforms(keys, rng.CAMERA_TAG, 4),
                       plain(keys, rng.CAMERA_TAG, 1, 4).T)
    assert torch.equal(rng.bounce_uniforms(keys, 7, 5),
                       plain(keys, 7, 1, 5).T)
    assert rng.KERNEL_LAUNCHES == before
