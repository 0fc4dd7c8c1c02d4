"""The SCONE pretrainers of the port against the JAX package: the object
and interior sample builders with the JAX keys injected
(``JaxSampleDraws``), a few occupancy and visibility steps from the JAX
initialisation with its step keys (``JaxSconeStepDraws``), the
checkpoints read both ways, and the CLI.

Tolerances, and why: a sample's integer and decision outputs exact (the
query points, their occupancy, the candidate cameras and their coverage
fractions, all host numpy or counts of exact ray tests); its partial
cloud within 1e-5 of its scale (the cast depths' and the unprojection's
f32 roundings, about 1e-6 of a world coordinate) and its view harmonics
within 1e-6 of their scale (sums in another order); the losses within
1e-5 relative (f32 sums in another order, autograd's against XLA's
gradients, three Adam steps) or 1e-7 absolute (the KL divergence sums
terms of order 1 that cancel to 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.models.scone import SconeOcc as JSconeOcc
from nextbestpath_tpu.models.scone import SconeVis as JSconeVis
from nextbestpath_tpu.train import pretrain_scone as JPS
from nextbestpath_tpu.utils.checkpoint import \
    load_checkpoint as j_load_checkpoint
from nextbestpath_tpu_torch.models.convert import (scone_occ_from_flax,
                                                   scone_vis_from_flax)
from nextbestpath_tpu_torch.models.scone import SconeOcc, SconeVis
from nextbestpath_tpu_torch.train import pretrain_scone as TPS
from nextbestpath_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCONE_PRE = os.path.join(ROOT, "weights", "scone_pre")
SMALL = dict(n_partial=256, n_query=128, n_candidates=4, n_views=2)
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-7


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class JaxSampleDraws:
    """A sample builder's key, PRNGKey(seed), split once a view."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def uniform(self, role, shape, step=None):
        self.key, sub = jax.random.split(self.key)
        return _t(jax.random.uniform(sub, tuple(shape)))


class JaxSconeStepDraws:
    """A pretrainer's step keys: PRNGKey(seed), split once a step. The
    occupancy step splits its key into the batch indices' and SconeOcc's
    (whose permutations split it again, global then per scale); the
    visibility step draws its indices from the step key itself."""

    def __init__(self, seed, occ):
        self.key, self.occ, self.cur = jax.random.PRNGKey(seed), occ, None

    def begin_group(self, role):
        self.key, self.cur = jax.random.split(self.key)

    def randint(self, role, low, high, step=None, shape=()):
        k = jax.random.split(self.cur)[0] if self.occ else self.cur
        return _t(jax.random.randint(k, tuple(shape), int(low),
                                     int(high))).long()

    def permutation(self, role, n, step=None):
        k_global, k_ds = jax.random.split(jax.random.split(self.cur)[1])
        k = k_global if step is None else jax.random.fold_in(k_ds, step)
        return _t(jax.random.permutation(k, n)).long()


def _same_sample(got, want):
    for f in ("query_x", "query_occ", "candidate_cams", "gt_coverage"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f, tol in (("partial_pc", 1e-5), ("view_harmonics", 1e-6)):
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * np.abs(b).max(), err_msg=f)


@pytest.fixture(scope="module")
def object_samples():
    """Three JAX object samples (families blob, superquadric, sq_bumps)."""
    return [JPS.make_pretrain_sample(s, **SMALL) for s in range(3)]


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_object_sample_matches_jax(seed):
    want = JPS.make_pretrain_sample(seed, **SMALL)
    got = TPS.make_pretrain_sample(seed, **SMALL, draws=JaxSampleDraws(seed),
                                   device="cpu")
    _same_sample(got, want)
    assert 0.0 < got.query_occ.mean() < 1.0 and got.gt_coverage.max() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_interior_sample_matches_jax(seed):
    """Walklet, carving and fov-restricted coverage over two scenes."""
    want = JPS.make_interior_sample(seed, **SMALL, scenes=2)
    got = TPS.make_interior_sample(seed, **SMALL, scenes=2,
                                   draws=JaxSampleDraws(seed), device="cpu")
    _same_sample(got, want)
    assert 0.0 < got.query_occ.mean() < 1.0


def test_visible_fov_fraction_matches_jax():
    """The coverage label of the interior samples on its own, with
    candidates facing every 45 degrees."""
    from nextbestpath_tpu.ops.raytrace import tris_to_soa as j_soa

    assets, soa = TPS._interior_scene(0, torch.device("cpu"))
    rng = np.random.default_rng(5)
    gt = assets.gt_surface[rng.permutation(len(assets.gt_surface))[:256]]
    pos = assets.gt_surface[:8].mean(axis=0)[None] + rng.normal(
        0, 1.0, (8, 3)).astype(np.float32)
    azim = np.arange(8) * 45.0
    elev = float(assets.elevations_deg[2])
    from nextbestpath_tpu.geometry.cameras import CameraIntrinsics as JIntr
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
    want = JPS.visible_fov_fraction(gt, pos, azim, elev,
                                    j_soa(jnp.asarray(assets.tris)),
                                    assets.n_tris,
                                    JIntr(image_height=64, image_width=114))
    got = TPS.visible_fov_fraction(gt, pos, azim, elev, soa, assets.n_tris,
                                   CameraIntrinsics(64, 114))
    assert got == want and max(got) > 0


def test_occ_steps_match_jax(object_samples):
    """Three occupancy steps of batch 2 from the JAX initialisation of
    ``pretrain_scone_occ`` (seed 5): the same losses."""
    seed, s0 = 5, object_samples[0]
    key = jax.random.PRNGKey(seed)
    jv = JSconeOcc(seq_len=256).init(
        key, jnp.asarray(s0.partial_pc)[None], jnp.asarray(s0.query_x)[None],
        jnp.asarray(s0.view_harmonics)[None], key=key)
    _, _, want = JPS.pretrain_scone_occ(n_steps=3, seed=seed,
                                        samples=object_samples, batch=2,
                                        verbose=False)
    m = SconeOcc(seq_len=256)
    m.load_state_dict(scone_occ_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                 jv)))
    model, got = TPS.pretrain_scone_occ(
        n_steps=3, seed=seed, samples=object_samples, batch=2, verbose=False,
        model=m, draws=JaxSconeStepDraws(seed, occ=True), device="cpu")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert model is m


@pytest.mark.parametrize("cov_loss", ["uncentered_l1", "kl_divergence"])
def test_vis_steps_match_jax(object_samples, cov_loss):
    """Three visibility steps of batch 2 from the JAX initialisation of
    ``pretrain_scone_vis`` (seed 5): the same losses."""
    seed, s0 = 5, object_samples[0]
    pts0 = jnp.concatenate([jnp.asarray(s0.query_x),
                            jnp.asarray(s0.query_occ)], axis=-1)[None]
    jv = JSconeVis().init(jax.random.PRNGKey(seed), pts0,
                          view_harmonics=jnp.asarray(s0.view_harmonics)[None])
    _, _, want = JPS.pretrain_scone_vis(n_steps=3, seed=seed,
                                        cov_loss=cov_loss,
                                        samples=object_samples, batch=2,
                                        verbose=False)
    m = SconeVis()
    m.load_state_dict(scone_vis_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                 jv)))
    _, got = TPS.pretrain_scone_vis(
        n_steps=3, seed=seed, cov_loss=cov_loss, samples=object_samples,
        batch=2, verbose=False, model=m,
        draws=JaxSconeStepDraws(seed, occ=False), device="cpu")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("name,cls,conv", [
    ("scone_occ", SconeOcc, scone_occ_from_flax),
    ("scone_vis", SconeVis, scone_vis_from_flax)])
def test_jax_checkpoints_load_strictly(name, cls, conv):
    """The tracked JAX-written SCONE checkpoints into the port's models."""
    variables = load_checkpoint(os.path.join(SCONE_PRE, f"{name}.ckpt"))[0]
    cls().load_state_dict(conv(variables), strict=True)


def test_cli_checkpoints_read_by_jax(tmp_path, capsys):
    """``pretrain_scone_torch.py both --device cpu --steps 3`` on two
    interior samples writes both checkpoints, which the JAX loader reads
    into flax's SconeOcc and SconeVis variable trees with the port's
    values."""
    import pretrain_scone_torch

    out = tmp_path / "scone"
    rc = pretrain_scone_torch.main(
        ["both", "--device", "cpu", "--steps", "3", "--n-objects", "2",
         "--batch", "2", "--domain", "interior", "--scenes", "1",
         "--out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "occ final loss" in text and "vis final loss" in text
    pc, x = jnp.zeros((1, 1024, 3)), jnp.zeros((1, 512, 3))
    vh = jnp.zeros((1, 512, 64))
    key = jax.random.PRNGKey(0)
    templates = {
        "scone_occ": jax.eval_shape(lambda k: JSconeOcc(seq_len=1024).init(
            k, pc, x, vh, key=k), key),
        "scone_vis": jax.eval_shape(lambda k: JSconeVis().init(
            k, jnp.zeros((1, 512, 4)), view_harmonics=vh), key)}
    for name, conv in (("scone_occ", scone_occ_from_flax),
                       ("scone_vis", scone_vis_from_flax)):
        path = str(out / f"{name}.ckpt")
        jv = j_load_checkpoint(path, templates[name])[0]
        want = conv(jax.tree_util.tree_map(np.asarray, jv))
        got = conv(load_checkpoint(path)[0])
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
