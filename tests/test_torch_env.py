"""tpt_torch.env against tpt.env: face selection, padding, the block table
and both samplers; blocked and planar lookups bit-identical in the port."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpt import env as jenv
from tpt_torch import env as tenv

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def faces(size=8, seed=0):
    return np.random.default_rng(seed).random((6, size, size, 3)).astype(np.float32)


def directions(n=5000, seed=1):
    r = np.random.default_rng(seed)
    d = r.normal(size=(3, n)).astype(np.float32)
    d[:, :6] = np.eye(3, 6, dtype=np.float32) - np.eye(3, 6, 3, dtype=np.float32)  # axes
    d[:, 6:10] = [[1, 1, 0, 0], [1, 0, 1, 0], [0, 1, 1, 0]]   # face-boundary ties, zero
    d[:, 10:] /= np.linalg.norm(d[:, 10:], axis=0)
    return d.reshape(3, 50, 100)


def test_face_uv_matches():
    d = directions()
    jf, js, jt = jenv.cubemap_face_uv_planar(*(jnp.asarray(c) for c in d))
    tf, ts, tt = tenv.cubemap_face_uv_planar(*(torch.from_numpy(c) for c in d))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)


@pytest.mark.parametrize("seamless", [False, True])
def test_padding_and_table_match(seamless):
    f = faces()
    np.testing.assert_array_equal(
        tenv.pad_faces_for_sampling(torch.from_numpy(f), seamless=seamless).numpy(),
        np.asarray(jenv.pad_faces_for_sampling(jnp.asarray(f), seamless=seamless)))
    np.testing.assert_array_equal(
        tenv.pack_block_table(torch.from_numpy(f), seamless=seamless).numpy(),
        np.asarray(jenv.pack_block_table(jnp.asarray(f), seamless=seamless)))


@pytest.mark.parametrize("seamless", [False, True])
def test_samplers_match_and_blocked_equals_planar(seamless):
    f, d = faces(), directions()
    want = np.asarray(jenv.sample_environment_planar(jnp.asarray(f), jnp.asarray(d),
                                                     seamless=seamless))
    planar = tenv.sample_environment_planar(torch.from_numpy(f), torch.from_numpy(d),
                                            seamless=seamless)
    table = tenv.pack_block_table(torch.from_numpy(f), seamless=seamless)
    blocked = tenv.sample_environment_blocked(table, torch.from_numpy(d))
    assert tenv.env_size_from_table(table) == 8
    np.testing.assert_array_equal(blocked.numpy(), planar.numpy())
    np.testing.assert_allclose(planar.numpy(), want, **TOL)
    # the zero direction (a path that never escaped) stays finite
    assert np.isfinite(planar.numpy()).all()


def test_constant_skybox_and_srgb():
    c = tenv.constant_environment((0.3, 0.45, 0.6), size=4)
    np.testing.assert_array_equal(
        c.numpy(), np.asarray(jenv.constant_environment((0.3, 0.45, 0.6), size=4)))
    np.testing.assert_allclose(tenv.default_skybox(16).numpy(),
                               np.asarray(jenv.default_skybox(16)), **TOL)
    x = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    np.testing.assert_allclose(tenv.srgb_to_linear(torch.from_numpy(x)).numpy(),
                               np.asarray(jenv.srgb_to_linear(x)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tenv.bundled_skybox().numpy(),
                               np.asarray(jenv.bundled_skybox()), rtol=1e-6, atol=1e-7)


def test_packed_face_uv_matches():
    d = np.moveaxis(directions(), 0, -1)                # [..., 3]
    jf, js, jt = jenv.cubemap_face_uv(jnp.asarray(d))
    tf, ts, tt = tenv.cubemap_face_uv(torch.from_numpy(d))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [1, 8])
def test_packed_samplers_match(size):
    """sample_environment and sample_environment_padded on [..., 3]
    directions (the pad ring, the window's clip at both edges, the blend
    order) against tpt.env's at rtol 1e-6, and equal to the port's planar
    sampler on the same directions."""
    f, d = faces(size, seed=size), np.moveaxis(directions(seed=size), 0, -1)
    want = np.asarray(jenv.sample_environment(jnp.asarray(f), jnp.asarray(d)))
    got = tenv.sample_environment(torch.from_numpy(f), torch.from_numpy(d))
    assert got.shape == d.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    padded = tenv.pad_faces_for_sampling(torch.from_numpy(f), seamless=True)
    want_padded = np.asarray(jenv.sample_environment_padded(
        jenv.pad_faces_for_sampling(jnp.asarray(f), seamless=True), jnp.asarray(d)))
    np.testing.assert_allclose(tenv.sample_environment_padded(padded, torch.from_numpy(d)),
                               want_padded, rtol=1e-6, atol=1e-7)
    planar = tenv.sample_environment_planar(torch.from_numpy(f),
                                            torch.from_numpy(np.moveaxis(d, -1, 0)))
    np.testing.assert_array_equal(np.moveaxis(planar.numpy(), 0, -1), got.numpy())
