"""The next-best-view cell at CPU sizes: whole runs past the harness's
look for a card (a sound run is correct; the control is not; with
SconeVis's output or the token draw altered in the timed path the run is
not correct), the
yardstick's operations against ``torch.utils.flop_counter`` on the plain
reference, and the readers of its per-layer metrics."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from nbp_bench import arith_scone, common, run
from nbp_bench.reference import scone as rs
from nbp_bench.tests.tiny import _edit, tiny_root

SMALL_OCC = {"seq_len": 128, "pts_embedding_dim": 32, "n_code": 2,
             "n_heads": 4, "global_feature_dim": 64, "n_scale": 2,
             "local_feature_dim": 32, "k_for_knn": 4, "x_embedding_dim": 64,
             "n_harmonics": 64}
SMALL_VIS = {"pts_embedding_dim": 64, "n_code": 3, "n_heads": 4,
             "n_harmonics": 64, "max_harmonic_rank": 8}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny tree with the cell's configuration and mix shrunk too:
    32x57 frames, 1,024 proxy points, the narrow SCONE models of the NBV
    checks, 2 scenes of 6 poses."""
    r = tiny_root(str(tmp_path_factory.mktemp("bench")))
    dst = os.path.join(r, "nbp_bench")
    _edit(os.path.join(dst, "configs", "macarons_nbv_f32.json"),
          params={"image_height": 32, "image_width": 57,
                  "points_per_frame": 96, "full_pc_capacity": 30000,
                  "n_gt_surface_points": 1000, "n_proxy_points": 1024,
                  "seq_len": 128},
          models={"scone_occ": SMALL_OCC, "scone_vis": SMALL_VIS},
          tokens={"surface": 128, "vis": 64, "proxy_queries": 64})
    _edit(os.path.join(dst, "mixes", "simple_nbv.json"), poses=6,
          warmup_poses=2, scene_seeds=[508, 509], check_poses=2,
          traced_poses=2)
    return r


def _run(root, capsys, seed, control=0, trace=0):
    rc = run.main(["--workload", "nbv_simple", "--seed", str(seed),
                   "--seconds", "0.5", "--trace", str(trace),
                   "--control", str(control)], device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct_and_the_control_is_not(root, capsys):
    line = _run(root, capsys, 2 ** 31 + 11, control=1)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"occ_err", "draw_err", "gain_err"}
    assert line["checks"]["draw_err"]["value"] <= 1e-5
    assert line["control_correct"] == {"control": False}, line
    assert line["attempted"] == 12 and line["failed"] == 0


def test_scone_vis_altered_in_the_timed_path_is_not_correct(
        root, capsys, monkeypatch):
    from nextbestpath_tpu_torch.models import scone

    real = scone.SconeVis.forward
    monkeypatch.setattr(scone.SconeVis, "forward",
                        lambda self, *a, **k: real(self, *a, **k) + 0.01)
    line = _run(root, capsys, 97)
    assert not line["correct"], line["checks"]
    assert line["checks"]["gain_err"]["value"] > \
        line["checks"]["gain_err"]["limit"]


def test_token_draw_altered_in_the_timed_path_is_not_correct(
        root, capsys, monkeypatch):
    """A draw that ignores the frustum (every point with enough occupancy
    may be drawn) reads far above ``draw_err``'s limit."""
    from nextbestpath_tpu_torch.sim import coverage_gain as cg

    real = cg.sample_proxy_points

    def no_frustum(noise, occ_probs, weights_mask, *a, **k):
        return real(noise, occ_probs, torch.ones_like(weights_mask), *a, **k)

    monkeypatch.setattr(cg, "sample_proxy_points", no_frustum)
    line = _run(root, capsys, 2 ** 32 + 5)
    assert not line["correct"], line["checks"]
    assert line["checks"]["draw_err"]["value"] > 1.0


def test_traced_run_reads_the_host_metrics(root, capsys):
    """On the CPU the device-trace readers find no device and give
    nothing; the host's read the window."""
    line = _run(root, capsys, 5, trace=1)
    m = line["metrics"]
    assert m["mfu.nbv"]["value"] > 0 and m["gains_ms.nbv"]["value"] > 0
    for name in ("scone_vis_roofline.nbv", "gumbel_roofline.nbv",
                 "k1_roofline.nbv", "k3_roofline.nbv"):
        assert name not in m, name


def _flops(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@pytest.mark.parametrize("n_tokens,n_queries", [(128, 24), (48, 16)])
def test_scone_flops_match_the_counter(n_tokens, n_queries):
    """arith_scone's operations equal FlopCounterMode's on the reference,
    SconeOcc at the small widths and SconeVis at the published ones."""
    from nextbestpath_tpu_torch.models.scone import SconeOcc, SconeVis

    torch.manual_seed(0)
    occ, vis = SconeOcc(**SMALL_OCC), SconeVis()
    net = rs.Scone({k: v.detach() for k, v in occ.state_dict().items()},
                   {k: v.detach() for k, v in vis.state_dict().items()},
                   k=SMALL_OCC["k_for_knn"], seq_len=SMALL_OCC["seq_len"])
    g = torch.Generator().manual_seed(1)
    pc = torch.rand(n_tokens, 3, generator=g)
    x = torch.rand(n_queries, 3, generator=g)
    vh = torch.rand(n_queries, 64, generator=g)
    f = net.ds_factor(n_tokens)
    perms = [torch.randperm(n_tokens, generator=g),
             torch.randperm(n_tokens, generator=g)]
    assert len(rs.knn(x, pc, 4)[1]) == 0  # no tied neighbours here
    assert len(rs.knn(x, pc[perms[1][:max(n_tokens // f, 4)]], 4)[1]) == 0
    with torch.no_grad():
        got = _flops(lambda: net.occ(pc, x, vh, perms))
        assert got == arith_scone.scone_occ_flops(n_tokens, n_queries,
                                                  SMALL_OCC)
        pts4 = torch.rand(3, n_tokens, 4, generator=g)
        vh4 = torch.rand(3, n_tokens, 64, generator=g)
        got = _flops(lambda: net.vis(pts4, vh4))
    published = json.load(open(os.path.join(
        common.BENCH_DIR, "configs", "macarons_nbv_f32.json")))["models"]
    assert got == arith_scone.scone_vis_flops(3, n_tokens,
                                              published["scone_vis"])


def test_published_pose_work():
    """A pose at the published sizes: SconeVis 274.47 GFLOP (6.70 MFLOP a
    token), SconeOcc 30.93 GFLOP, the token draw at least 0.196 ms (a
    logarithm a draw at 4.18e12 a second)."""
    cfg = json.load(open(os.path.join(common.BENCH_DIR, "configs",
                                      "macarons_nbv_f32.json")))
    w = arith_scone.pose_work(cfg, 20)
    assert round(w["vis_flops"] / 1e9, 2) == 274.47
    assert round(w["occ_flops"] / 1e9, 2) == 30.93
    assert w["draw_bound_s"] == 20 * 2048 * 20000 / (16 * 132 * 1.98e9)
    assert round(w["draw_bound_s"] * 1e3, 3) == 0.196


class _Ev:
    """A stand-in for the profiler's events."""

    def __init__(self, name, t0, t1, dev=False, corr=0, annot=False):
        self.n, self.t0, self.t1 = name, t0, t1
        self.dev, self.corr, self.annot = dev, corr, annot

    def name(self):
        return self.n

    def start_ns(self):
        return self.t0

    def end_ns(self):
        return self.t1

    def device_type(self):
        d = torch.autograd.DeviceType
        return d.CUDA if self.dev else d.CPU

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return 0

    def is_user_annotation(self):
        return self.annot


def test_kernels_are_tied_to_their_launching_span():
    """A kernel counts in a span when its launch does, whenever it runs;
    overlapping kernels count once."""
    from nbp_bench.metrics import nbv_spans

    ev = [_Ev("gumbel", 0, 100), _Ev("sample", 200, 300),
          _Ev("cudaLaunchKernel", 10, 11, corr=1),
          _Ev("cudaLaunchKernel", 150, 151, corr=2),
          _Ev("cudaLaunchKernel", 250, 251, corr=3),
          _Ev("k1", 1000, 2000, dev=True, corr=1),
          _Ev("k2", 2000, 3000, dev=True, corr=2),
          _Ev("k3", 1500, 2500, dev=True, corr=3),
          _Ev("gumbel", 1000, 1100, dev=True, annot=True)]
    layer = {"events": ev}
    assert nbv_spans.device_s_in_spans(layer, ("gumbel",)) == 1e-6
    assert nbv_spans.device_s_in_spans(layer, ("gumbel", "sample")) == \
        pytest.approx(1.5e-6)
    assert nbv_spans.device_s_in_spans(layer, ("scone_vis",)) is None
