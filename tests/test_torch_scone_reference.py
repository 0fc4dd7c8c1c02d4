"""The port's SCONE networks and predicted gain against the benchmark's
plain reference (``nbp_bench/reference/scone.py``), with seeded weights
on the CPU, at the small widths of the NBV checks and at the published
widths with a few dozen tokens: each within the limit that the
``nbv_simple`` cell's configuration sets for it, and the reference with
TF32-rounded products (the cell's control) outside one. Then the NBV
rollout's ``vis_tokens`` keyword and its ``nbv`` run record."""

import json
import math
import os

import numpy as np
import pytest
import torch

from nbp_bench import checks_nbv
from nbp_bench.reference import scone as rs
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.draws import TorchDraws
from nextbestpath_tpu_torch.eval import macarons_nbv as TN
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
from nextbestpath_tpu_torch.sim import coverage_gain as CG
from nextbestpath_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "nbp_bench", "configs",
                       "macarons_nbv_f32.json")) as _f:
    LIMITS = json.load(_f)["limits"]
H, W = 32, 56


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class PermDraws(TorchDraws):
    """The port's provider, keeping the permutations it serves."""

    def __init__(self, seed):
        super().__init__(seed, torch.device("cpu"))
        self.perms = []

    def permutation(self, role, n, step=None):
        out = super().permutation(role, n, step)
        self.perms.append(out)
        return out


def _sd(model):
    return {k: v.detach() for k, v in model.state_dict().items()}


def _occ_errs(small, n_tokens, n_queries, seed=0):
    """(program's, control's) occ_err on random tokens and queries."""
    occ, _ = TN.seeded_scone(seed, small=small)
    g = torch.Generator().manual_seed(seed + 1)
    pc = torch.rand(n_tokens, 3, generator=g) - 0.5
    x = torch.rand(n_queries, 3, generator=g) - 0.5
    vh = 0.3 * torch.randn(n_queries, 64, generator=g)
    draws = PermDraws(seed + 2)
    with torch.no_grad():
        prog = occ(pc[None], x[None], vh[None], draws=draws)[0, :, 0]
        kw = dict(k=occ.k_for_knn, seq_len=occ.seq_len)
        ref, alts = rs.Scone(_sd(occ), **kw).occ_alternatives(
            pc, x, vh, draws.perms)
        ctl = rs.Scone(_sd(occ), tf32=True, **kw).occ(pc, x, vh,
                                                      draws.perms)
    return (float(checks_nbv._occ_errs(prog, ref, alts).max()),
            float(checks_nbv._occ_errs(ctl, ref, alts).max()))


def _cameras(n):
    """n poses (x, y, z, elevation, azimuth) on a circle of radius 9
    about the origin, looking at it."""
    out = []
    for i in range(n):
        a = 2.0 * math.pi * i / n
        x, z = 9.0 * math.sin(a), 9.0 * math.cos(a)
        azim = math.degrees(math.atan2(-x, -z)) % 360.0
        out.append([x, 0.5, z, -5.0, azim])
    return torch.tensor(out, dtype=torch.float32)


def _gain_errs(small, n_tokens, n_proxy=400, seed=0):
    """The program's and the control's gain_err and draw_err of
    predict_coverage_gain with served Gumbel noise, 4 candidates around a
    box of proxy points, the reference drawing the tokens itself:
    {"gain": (program, control), "draw": (program, control)}."""
    _, vis = TN.seeded_scone(seed, small=small)
    g = torch.Generator().manual_seed(seed + 3)
    lo, hi = torch.full((3,), -4.0), torch.full((3,), 4.0)
    proxy = lo + (hi - lo) * torch.rand(n_proxy, 3, generator=g)
    proba = torch.rand(n_proxy, 1, generator=g)
    vh = 0.3 * torch.randn(n_proxy, 64, generator=g)
    poses = _cameras(4)
    draws = TorchDraws(seed + 4, torch.device("cpu"))
    noise = draws.gumbels("gain", [(n_tokens, n_proxy)] * poses.shape[0])
    seen = []
    hook = vis.register_forward_hook(lambda m, a, out: seen.append(a[0]))
    intr = CameraIntrinsics(image_height=H, image_width=W)
    try:
        prog = CG.predict_coverage_gain(noise, vis, proxy, proba, vh, poses,
                                        intr, lo, hi, sensor_range=70.0)
    finally:
        hook.remove()
    geo = dict(H=H, W=W, fov_deg=intr.fov_degrees, max_range=70.0)
    drawn = checks_nbv.draw_reading(noise, seen[0], proxy, proba[:, 0],
                                    poses, lo, hi, geo, 0.1, control=True)
    assert drawn["unmatched"] == 0
    terms, ctl = [], []
    with torch.no_grad():
        for c in range(poses.shape[0]):
            args = dict(proxy=proxy, occ=proba[:, 0], vh=vh,
                        idx=drawn["idx"][c], pose5=poses[c], box_min=lo,
                        box_max=hi, **geo)
            terms.append(rs.gain_terms(rs.Scone(None, _sd(vis)), **args))
            ctl.append(rs.gain_terms(rs.Scone(None, _sd(vis), tf32=True),
                                     **args)["gain"])
    valid = [True] * poses.shape[0]
    assert all(t["gain"] > 0 for t in terms)
    return {"gain": (checks_nbv._gain_err(prog, terms, valid)[0],
                     checks_nbv._gain_err(ctl, terms, valid)[0]),
            "draw": (drawn["draw_err"], drawn["ctl_draw_err"])}


@pytest.mark.parametrize("small,n_tokens,n_queries",
                         [(True, 128, 64), (False, 40, 24)])
def test_scone_occ_matches_the_reference(small, n_tokens, n_queries):
    """SconeOcc (global, kNN scales, head) within ``occ_err``'s limit; the
    TF32 control outside it."""
    err, ctl = _occ_errs(small, n_tokens, n_queries)
    assert err <= LIMITS["occ_err"], err
    assert ctl > LIMITS["occ_err"], ctl


@pytest.mark.parametrize("small,n_tokens", [(True, 64), (False, 32)])
def test_coverage_gain_matches_the_reference(small, n_tokens):
    """SconeVis and predict_coverage_gain from served noise (the tokens
    the program drew, read from SconeVis's input) within ``gain_err``'s
    limit; the TF32 control outside it."""
    err, ctl = _gain_errs(small, n_tokens)["gain"]
    assert err <= LIMITS["gain_err"], err
    assert ctl > LIMITS["gain_err"], ctl


@pytest.mark.parametrize("seed", [0, 1])
def test_token_draw_matches_the_reference(seed):
    """The program's occupancy-weighted Gumbel-max draw against the
    reference's own from the same noise, 4 candidates of 1,024 tokens
    over 2,000 proxy points, within ``draw_err``'s limit; the control's
    (its addends rounded to TF32) outside it."""
    err, ctl = _gain_errs(True, 1024, n_proxy=2000, seed=seed)["draw"]
    assert err <= LIMITS["draw_err"], err
    assert ctl > LIMITS["draw_err"], ctl


def test_token_draw_outside_the_frustum_is_caught():
    """A token outside a candidate's frustum, or one that is no proxy
    point, reads far above ``draw_err``'s limit."""
    g = torch.Generator().manual_seed(11)
    proxy = 8.0 * torch.rand(300, 3, generator=g) - 4.0
    proba = 0.2 + 0.8 * torch.rand(300, generator=g)
    pose5 = _cameras(4)[:1]
    noise = [TorchDraws(12, torch.device("cpu")).gumbel("gain", (16, 300))]
    geo = dict(H=H, W=W, fov_deg=60.0, max_range=70.0)
    inside, undecided = rs.in_frustum(proxy, pose5[0], **geo)
    hyps = rs.draw_logits(proba, inside, undecided, 0.1)
    own = rs.draw_gaps(noise[0], hyps, None)[1]
    outside = torch.nonzero(~inside).flatten()[:16]

    def tokens(idx):
        tok = proxy[idx]
        centre = (tok.amax(0) + tok.amin(0)) / 2.0
        diag = torch.linalg.norm(torch.full((3,), 8.0))
        return torch.cat([(tok - centre) / diag, proba[idx, None]], -1)[None]

    box = (torch.full((3,), -4.0), torch.full((3,), 4.0))
    sound = checks_nbv.draw_reading(noise, tokens(own), proxy, proba, pose5,
                                    *box, geo, 0.1, control=False)
    assert sound["draw_err"] == 0.0 and sound["unmatched"] == 0
    bad = own.clone()
    bad[:8] = outside[:8]
    wrong = checks_nbv.draw_reading(noise, tokens(bad), proxy, proba, pose5,
                                    *box, geo, 0.1, control=False)
    assert wrong["draw_err"] > 20.0 and wrong["unmatched"] == 0
    far = tokens(own)
    far[0, 3, :3] += 0.05
    lost = checks_nbv.draw_reading(noise, far, proxy, proba, pose5, *box,
                                   geo, 0.1, control=False)
    assert lost["unmatched"] == 1 and lost["draw_err"] == checks_nbv.UNMATCHED


def test_view_harmonics_match_the_port():
    """The view states' harmonics from the closed form against the port's
    basis and projection."""
    from nextbestpath_tpu_torch.models.harmonics import base_view_harmonics
    from nextbestpath_tpu_torch.ops.view_state import compute_view_harmonics

    g = torch.Generator().manual_seed(13)
    vs = (torch.rand(1, 50, 98, generator=g) < 0.3).float()
    base, polar = base_view_harmonics(7, 14, 8)
    got = compute_view_harmonics(vs, base, polar, 7, 14)[0]
    torch.testing.assert_close(got.double(), rs.view_harmonics(vs[0], 7, 14),
                               rtol=1e-5, atol=1e-6)


def test_scone_vis_matches_the_reference():
    """SconeVis's coefficients at the published width, token by token."""
    _, vis = TN.seeded_scone(5)
    g = torch.Generator().manual_seed(6)
    pts4 = torch.cat([torch.rand(2, 40, 3, generator=g) - 0.5,
                      torch.rand(2, 40, 1, generator=g)], -1)
    vh = 0.3 * torch.randn(2, 40, 64, generator=g)
    with torch.no_grad():
        got = vis(pts4, view_harmonics=vh)
        want = rs.Scone(None, _sd(vis)).vis(pts4, vh)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_harmonics_match_the_port():
    """The closed-form harmonics against the port's recursion."""
    from nextbestpath_tpu_torch.models.harmonics import harmonics_up_to_rank

    g = torch.Generator().manual_seed(7)
    theta = math.pi * torch.rand(500, generator=g, dtype=torch.float64)
    phi = 2 * math.pi * torch.rand(500, generator=g,
                                   dtype=torch.float64) - math.pi
    torch.testing.assert_close(rs.harmonics(theta, phi),
                               harmonics_up_to_rank(8, theta, phi),
                               rtol=1e-9, atol=1e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -12), 3.0 + 2 ** -9])
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -9, -1.0, 3.0 + 2 ** -9])
    assert torch.equal(rs.tf32_round(x), want)


@pytest.fixture(scope="module")
def small_scene():
    params = TC.default_params(**TN.NBV_SMALL)
    return TA.pack_generated_scene(TA.generate_scene("simple", seed=6),
                                   params=params), params


def _rollout(small_scene, models, **kw):
    assets, params = small_scene
    occ, vis = models
    seen = []
    hook = vis.register_forward_hook(
        lambda m, args, out: seen.append(tuple(args[0].shape)))
    try:
        res = TN.macarons_nbv_rollout(
            assets, occ, vis, params=params, n_poses=2, seed=4,
            device="cpu", **TN.NBV_SMALL_TOKENS, **kw)
    finally:
        hook.remove()
    return res, seen


def test_vis_tokens_keyword_and_the_nbv_record(small_scene, monkeypatch):
    """vis_tokens=None keeps the JAX package's cap (min(seq_len, 1024)
    tokens a candidate, the rollout unchanged); vis_tokens=N hands N
    tokens to SconeVis. The pose loop's ``nbv`` record carries the
    spans, the valid candidates and the four counters, a pose at a
    time."""
    models = TN.seeded_scone(0, small=True)
    seq = min(int(small_scene[1].seq_len), 1024)
    base, seen = _rollout(small_scene, models)
    assert seen == [(TN.C_MAX, seq, 4)] * 2
    same, _ = _rollout(small_scene, models, vis_tokens=seq)
    assert same.coverage_evolution == base.coverage_evolution
    np.testing.assert_array_equal(same.cam_positions, base.cam_positions)

    valid = []
    real = TN.neighbour_candidates

    def keep(*a):
        out = real(*a)
        valid.append(out[1])
        return out

    monkeypatch.setattr(TN, "neighbour_candidates", keep)
    _, seen = _rollout(small_scene, models, vis_tokens=24)
    assert seen == [(TN.C_MAX, 24, 4)] * 2
    rec = timing.records()[-1]
    assert rec.kind == "nbv" and rec.units["poses"] == 2
    assert rec.units["candidates"] == sum(int(v.sum()) for v in valid)
    assert rec.counts == {
        "vis_tokens": 2 * TN.C_MAX * 24,
        "occ_queries": 2 * TN.NBV_SMALL_TOKENS["n_proxy_tokens"],
        "host_reads": 4, "launches": 0}
    for name in ("coverage", "carve", "occupancy", "gumbel", "gains",
                 "sample", "scone_vis", "move"):
        assert rec.n(name) == 2, name
