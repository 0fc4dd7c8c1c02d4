"""Coverage metric of the PyTorch port against the JAX package.

JAX side: ``min_dists(..., use_kernel=True)`` runs the Pallas kernel in
interpret mode on the CPU, as tests/test_coverage_kernel.py does. Both
compute exact f32 differences, so distances agree to 1e-6 relative;
coverage agrees to within one GT point. The stride subsample's indices
(with their int32 wraparound) must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.ops import coverage as J
from nextbestpath_tpu_torch.ops import coverage as T


def _clouds(G=700, S=2048, scale=100.0, seed=3):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-scale, scale, (G, 3)).astype(np.float32)
    pts = rng.uniform(-scale, scale, (S, 3)).astype(np.float32)
    return gt, pts


@pytest.mark.parametrize("count", [1, 17, 1000, 2048])
def test_min_dists_matches_pallas(count):
    gt, pts = _clouds()
    valid = np.arange(pts.shape[0]) < count
    want = np.asarray(J.min_dists(jnp.asarray(gt), jnp.asarray(pts),
                                  jnp.asarray(valid), s_count=jnp.int32(count),
                                  use_kernel=True))
    got = T.min_dists(torch.from_numpy(gt), torch.from_numpy(pts),
                      torch.from_numpy(valid),
                      s_count=torch.tensor(count, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_min_dists_empty_is_huge():
    gt, pts = _clouds(G=50, S=64)
    got = T.min_dists(torch.from_numpy(gt), torch.from_numpy(pts),
                      torch.zeros(64, dtype=torch.bool), s_count=0)
    assert float(got.min()) > 1e6


def test_masked_min_dists_matches_jnp_path():
    gt, pts = _clouds(G=300, S=1024, seed=5)
    valid = np.random.default_rng(6).random(1024) < 0.5
    want = np.asarray(J.masked_min_dists(jnp.asarray(gt), jnp.asarray(pts),
                                         jnp.asarray(valid), chunk=1024))
    got = T.masked_min_dists(torch.from_numpy(gt), torch.from_numpy(pts),
                             torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("count", [0, 1, 5, 1500, 65536, 2_000_000])
def test_stride_subsample_matches(count):
    key = jax.random.PRNGKey(count + 1)
    n_sample = 40960
    cap = max(count, 8192)
    idx_j, valid_j = J.stride_subsample(key, jnp.int32(count), cap, n_sample)
    c = max(count, 1)
    start = int(jax.random.randint(key, (), 0, c))
    half = int(jax.random.randint(jax.random.fold_in(key, 1), (), 1,
                                  max(c // 2, 2)))
    idx_t, valid_t = T.stride_subsample(torch.tensor(start), torch.tensor(half),
                                        torch.tensor(count), n_sample)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))


@pytest.mark.parametrize("G,cap", [(1500, 8192), (20000, 2_000_000), (100, 1000)])
def test_n_sample_matches(G, cap):
    raw = G * 2
    chunk = 8192 if (raw >= 8192 and cap >= 8192) else 2048
    n = ((raw + chunk - 1) // chunk) * chunk
    if n > cap:
        n = max((cap // chunk) * chunk, chunk)
    assert T.n_sample_for(G, cap) == n


def test_coverage_percentage_matches():
    rng = np.random.default_rng(11)
    gt = rng.uniform(-50, 50, (1500, 3)).astype(np.float32)
    buf = np.zeros((8192, 3), np.float32)
    buf[:1500] = gt + 0.3 * rng.normal(size=gt.shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    count = 1500
    want = float(J.coverage_percentage(jnp.asarray(gt), jnp.asarray(buf),
                                       jnp.int32(count), key,
                                       fast_sampling=True, use_kernel=True))
    start = jax.random.randint(key, (), 0, count)
    half = jax.random.randint(jax.random.fold_in(key, 1), (), 1, count // 2)
    got = float(T.coverage_percentage(torch.from_numpy(gt), torch.from_numpy(buf),
                                      torch.tensor(count, dtype=torch.int32),
                                      torch.tensor(int(start)),
                                      torch.tensor(int(half))))
    assert want > 0.3
    assert abs(got - want) < 1.0 / 1500
    zero = T.coverage_percentage(torch.from_numpy(gt), torch.from_numpy(buf),
                                 torch.tensor(0, dtype=torch.int32),
                                 torch.tensor(0), torch.tensor(1))
    assert float(zero) == 0.0


def test_compute_auc_matches():
    y = np.random.default_rng(0).random(17)
    assert T.compute_auc(y) == pytest.approx(J.compute_auc(y), abs=1e-12)
