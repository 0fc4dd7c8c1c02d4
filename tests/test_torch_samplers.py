"""The samplers and appends of the capture options and the legacy metric,
against the JAX package on the same draws:

* ``ops.coverage.subsample_buffer`` (the argsort sampler): indices and
  validity exactly, also with deliberately tied scores, and the metric
  over it (``coverage_percentage_exact``) within 1e-6;
* the stratified ``sim.sensor.backproject_sample``: validity exactly and
  the same pixels (world points within 1e-5; f32 products summed in
  another order, one ulp apart at most), and its fall-back to the iid
  draw where a stratum could keep two points;
* ``PointBuffer.append(prefix_valid=False)``, ``PointBuffer.append_batches``
  and ``TrajectoryBuffer.append_many``: bit for bit;
* ``move_and_capture(batched=True)``: bit for bit against the unbatched
  capture of the port (the JAX package allows one ulp between its two), and
  against the JAX batched capture with the stratified draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.geometry import CameraIntrinsics as JIntr
from nextbestpath_tpu.geometry import get_camera_RT as j_get_camera_RT
from nextbestpath_tpu.ops import coverage as JC
from nextbestpath_tpu.ops.raytrace import render_depth as j_render_depth
from nextbestpath_tpu.ops.raytrace import tris_to_soa as j_soa
from nextbestpath_tpu.sim import rollout as JR
from nextbestpath_tpu.sim import sensor as JS
from nextbestpath_tpu_torch.draws import TorchDraws, frame_draws
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
from nextbestpath_tpu_torch.ops import coverage as TC
from nextbestpath_tpu_torch.ops.raytrace import tris_to_soa
from nextbestpath_tpu_torch.sim import rollout as TR
from nextbestpath_tpu_torch.sim import sensor as TS

from test_torch_legacy_rollout import JaxSequentialDraws

H, W = 32, 56
PTS_ATOL = 1e-5  # measured 7.6e-6: one ulp of a point ~60 from the origin


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scene():
    return pack_generated_scene(generate_scene("simple", seed=8))


def _frame(assets, pos=(7.0, 3.3, 7.0), ang=(0.0, 45.0)):
    intr = JIntr(H, W, 60.0, 1.0, 750.0)
    R, T = j_get_camera_RT(jnp.asarray([pos], jnp.float32),
                           jnp.asarray([ang], jnp.float32))
    zbuf = j_render_depth(j_soa(jnp.asarray(assets.tris)), assets.n_tris,
                          R[0], T[0], intr)
    return zbuf, R[0], T[0], intr


@pytest.mark.parametrize("capacity,count,n_sample", [
    (4096, 0, 1024), (4096, 700, 1024), (4096, 3000, 1024),
    (4096, 4096, 2048), (1 << 18, 200_000, 8192)])
def test_subsample_buffer_matches_jax(capacity, count, n_sample):
    key = jax.random.PRNGKey(count + 1)
    idx_j, valid_j = JC.subsample_buffer(key, jnp.int32(count), capacity,
                                         n_sample)
    u = _t(jax.random.uniform(key, (capacity,)))
    idx, valid = TC.subsample_buffer(u, torch.tensor(count, dtype=torch.int32),
                                     n_sample)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    assert int(valid.sum()) == min(count, n_sample)


def test_subsample_buffer_ties_go_to_the_lower_slot(monkeypatch):
    """Scores on a grid of 1/64 tie in every cell; both samplers keep the
    tied slots in slot order."""
    capacity, count, n_sample = 8192, 5000, 2048
    rng = np.random.default_rng(0)
    tied = (np.floor(rng.random(capacity) * 64) / 64).astype(np.float32)
    monkeypatch.setattr(JC.jax.random, "uniform",
                        lambda key, shape: jnp.asarray(tied))
    idx_j, valid_j = JC.subsample_buffer(jax.random.PRNGKey(0),
                                         jnp.int32(count), capacity, n_sample)
    idx, valid = TC.subsample_buffer(_t(tied), torch.tensor(count), n_sample)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    assert len(np.unique(tied[:count])) == 64


@pytest.mark.parametrize("count", [0, 1500, 9000])
def test_exact_coverage_matches_jax(count):
    rng = np.random.default_rng(count)
    gt = rng.uniform(-5, 5, (512, 3)).astype(np.float32)
    pts = np.zeros((16384, 3), np.float32)
    pts[:count] = gt[rng.integers(0, 512, count)] + rng.normal(
        0, 0.8, (count, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = float(JC.coverage_percentage(jnp.asarray(gt), jnp.asarray(pts),
                                        jnp.int32(count), key))
    got = float(TC.coverage_percentage_exact(
        _t(gt), _t(pts), torch.tensor(count, dtype=torch.int32),
        _t(jax.random.uniform(key, (16384,)))))
    assert got == pytest.approx(want, abs=1e-6)
    assert (got > 0) == (count > 0)


# (256, 0.05) and (1792, 0.5): a stratum of 7 or 1 pixels keeps at most
# one point, so the stratified draw applies; (64, 0.5) and (128, 0.1): 28
# or 14 pixels a stratum could keep 14 or 1.4, so both packages fall back
# to the iid draw.
@pytest.mark.parametrize("n_slots,gf,applies", [(256, 0.05, True),
                                                (64, 0.5, False),
                                                (1792, 0.5, True),
                                                (128, 0.1, False)])
def test_stratified_backproject_matches_jax(scene, n_slots, gf, applies):
    zbuf, R, T, intr = _frame(scene)
    key = jax.random.PRNGKey(11)
    want = JS.backproject_sample(zbuf, R, T, intr, key, n_slots,
                                 gathering_factor=gf, stratified=True)
    assert TS.stratified_applies(H * W, n_slots, gf) == applies
    draws = JaxSequentialDraws(0)
    draws.cur = key
    scores, ranks = frame_draws(draws, "obs", H * W, n_slots, applies)
    got = TS.backproject_sample(_t(zbuf), _t(R), _t(T),
                                CameraIntrinsics(H, W, 60.0, 1.0, 750.0),
                                scores, n_slots, gathering_factor=gf,
                                ranks_u=ranks)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    assert v.sum() > 0 and v[:v.sum()].all()
    np.testing.assert_allclose(got.points.numpy()[v],
                               np.asarray(want.points)[v], atol=PTS_ATOL)


def test_stratified_draw_keeps_one_point_a_stratum(scene):
    zbuf, R, T, _ = _frame(scene)
    n_slots = 256
    group = -(-H * W // n_slots)
    gen = torch.Generator().manual_seed(0)
    got = TS.backproject_sample(_t(zbuf), _t(R), _t(T),
                                CameraIntrinsics(H, W, 60.0, 1.0, 750.0),
                                torch.rand(H * W, generator=gen), n_slots,
                                ranks_u=torch.rand(n_slots, generator=gen))
    n_valid = int(((_t(zbuf) > -1) & (_t(zbuf).clamp(0.5, 750.0) < 70)).sum())
    assert int(got.valid.sum()) == int(0.05 * n_valid)
    # Distinct strata: every kept point is a different stratum's pixel.
    pts = got.points[got.valid]
    assert len(torch.unique(pts, dim=0)) == len(pts)
    assert group == 7


def _batch(rng, n, p, n_valid, prefix=True):
    pts = rng.normal(size=(n, p, 3)).astype(np.float32)
    valid = np.zeros((n, p), bool)
    for b, k in enumerate(n_valid):
        if prefix:
            valid[b, :k] = True
        else:
            valid[b, rng.choice(p, k, replace=False)] = True
    return pts, valid


def test_append_compacts_scattered_valid_rows():
    rng = np.random.default_rng(0)
    cap = 40
    pj = JS.PointBuffer.create(cap)
    pt = TS.PointBuffer.create(cap, "cpu")
    pts, valid = _batch(rng, 4, 16, (10, 0, 16, 12), prefix=False)
    for b in range(4):  # the third batch overflows the capacity
        pj = pj.append(JS.FramePoints(jnp.asarray(pts[b]),
                                      jnp.asarray(valid[b])),
                       prefix_valid=False)
        pt.append(TS.FramePoints(_t(pts[b]), _t(valid[b])),
                  prefix_valid=False)
        assert int(pt.count) == int(pj.count)
        np.testing.assert_array_equal(pt.points.numpy(), np.asarray(pj.points))


@pytest.mark.parametrize("cap", [4096, 50])
def test_append_batches_matches_jax_and_sequential_appends(cap):
    rng = np.random.default_rng(1)
    pts, valid = _batch(rng, 4, 16, (10, 0, 16, 7))
    pj = JS.PointBuffer.create(cap).append_batches(jnp.asarray(pts),
                                                   jnp.asarray(valid))
    pt = TS.PointBuffer.create(cap, "cpu")
    pt.append_batches(_t(pts), _t(valid))
    seq = TS.PointBuffer.create(cap, "cpu")
    for b in range(4):
        seq.append(TS.FramePoints(_t(pts[b]), _t(valid[b])))
    assert int(pt.count) == int(pj.count) == int(seq.count)
    np.testing.assert_array_equal(pt.points.numpy(), np.asarray(pj.points))
    assert torch.equal(pt.points, seq.points)


@pytest.mark.parametrize("cap,start", [(16, 0), (6, 3), (3, 3)])
def test_append_many_matches_jax(cap, start):
    xyz = np.arange(12, dtype=np.float32).reshape(4, 3) + 1
    tj = JR.TrajectoryBuffer.create(cap)
    tt = TR.TrajectoryBuffer.create(cap, "cpu")
    for i in range(start):
        tj = tj.append(jnp.full(3, -i, jnp.float32))
        tt.append(torch.full((3,), -float(i)))
    tj = tj.append_many(jnp.asarray(xyz))
    tt.append_many(_t(xyz))
    assert int(tt.count) == int(tj.count)
    np.testing.assert_array_equal(tt.xyz.numpy(), np.asarray(tj.xyz))


def _capture_args(scene):
    old = np.array([7.0, 3.3, 7.0, 0.0, 315.0], np.float32)
    new = np.array([10.0, 3.3, 7.0, 0.0, 0.0], np.float32)
    return old, new, dict(n_steps=4, n_azim=8, n_slots=256)


@pytest.mark.parametrize("stratified", [False, True])
def test_batched_capture_equals_unbatched(scene, stratified):
    intr = CameraIntrinsics(H, W, 60.0, 1.0, 750.0)
    old, new, kw = _capture_args(scene)
    soa = tris_to_soa(_t(scene.tris))
    draws = TorchDraws(3, torch.device("cpu"))
    frames = [frame_draws(draws, "move", H * W, 256, stratified, step=s)
              for s in range(1, 5)]
    outs = []
    for batched in (False, True):
        pc = TS.PointBuffer.create(4096, "cpu")
        tr = TR.TrajectoryBuffer.create(16, "cpu")
        TR.move_and_capture(soa, scene.n_tris, _t(old), _t(new), pc, tr,
                            [f[0] for f in frames], intr,
                            frame_ranks=([f[1] for f in frames]
                                         if stratified else None),
                            batched=batched, **kw)
        outs.append((pc, tr))
    (pa, ta), (pb, tb) = outs
    assert int(pa.count) == int(pb.count) > 0
    assert torch.equal(pa.points, pb.points)
    assert int(ta.count) == int(tb.count) == 4
    assert torch.equal(ta.xyz, tb.xyz)


def test_batched_stratified_capture_matches_jax(scene):
    intr_j = JIntr(H, W, 60.0, 1.0, 750.0)
    old, new, kw = _capture_args(scene)
    key = jax.random.PRNGKey(5)
    pc_j, tr_j, z_j = JR.move_and_capture(
        j_soa(jnp.asarray(scene.tris)), jnp.asarray(scene.n_tris, jnp.int32),
        jnp.asarray(old), jnp.asarray(new), JS.PointBuffer.create(4096),
        JR.TrajectoryBuffer.create(16), key, intr_j, stratified=True,
        batched=True, **kw)
    draws = JaxSequentialDraws(0)
    draws.cur = key
    frames = [frame_draws(draws, "move", H * W, 256, True, step=s)
              for s in range(1, 5)]
    pc = TS.PointBuffer.create(4096, "cpu")
    tr = TR.TrajectoryBuffer.create(16, "cpu")
    _, _, z = TR.move_and_capture(tris_to_soa(_t(scene.tris)), scene.n_tris,
                                  _t(old), _t(new), pc, tr,
                                  [f[0] for f in frames],
                                  CameraIntrinsics(H, W, 60.0, 1.0, 750.0),
                                  frame_ranks=[f[1] for f in frames],
                                  batched=True, **kw)
    n = int(pc.count)
    assert n == int(pc_j.count) > 0
    np.testing.assert_allclose(pc.points[:n].numpy(),
                               np.asarray(pc_j.points)[:n], atol=PTS_ATOL)
    np.testing.assert_allclose(tr.xyz.numpy(), np.asarray(tr_j.xyz), atol=1e-6)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-4)
