"""The port's spans, counters and run records (``utils/timing.py``): self
time on nested spans, the bounded record list, no profiler op while no
profiler records, the spans as profiler ranges on the profiler's clock,
and the records that a CPU walk rollout and a CPU training pass leave.
"""

import random
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nextbestpath_tpu_torch.utils import timing

WALK_SPANS = ("rollout", "init", "draws", "pose", "results")
PASS_SPANS = ("pass", "shuffle", "chunk", "forward", "batch", "backward",
              "accumulate", "optimizer", "loss_read")


def _new_records(before):
    """The records added since ``before`` (a ``timing.records()``)."""
    seen = {id(r) for r in before}
    return [r for r in timing.records() if id(r) not in seen]


def _walk(n_scenes=2):
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.assets.scene_assets import \
        pad_assets_to_common
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval.random_walk import ScanRandomWalk

    params = default_params(image_height=16, image_width=28,
                            points_per_frame=64, full_pc_capacity=4096,
                            n_gt_surface_points=256)
    assets = pad_assets_to_common([
        pack_generated_scene(generate_scene("simple", seed=s), params=params)
        for s in range(1, n_scenes + 1)])
    return ScanRandomWalk(assets, params=params, device="cpu")


def _training(rows=6):
    from nextbestpath_tpu_torch.models.unet import NBP
    from nextbestpath_tpu_torch.train import train_nbp as T
    from nextbestpath_tpu_torch.train.replay import Experience

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    S = 32
    data = [Experience(
        model_input=rng.random((5, S, S)).astype(np.float16),
        gt_layout=(rng.random((S, S)) > 0.7).astype(np.uint8),
        pixels=np.stack([rng.integers(0, 8, 3), rng.integers(0, S // 4, 3),
                         rng.integers(0, S // 4, 3)], 1).astype(np.int32),
        gains=rng.random(3).astype(np.float32), pose_i=20 + i)
        for i in range(rows)]
    state = T.init_train_state(NBP(width=4), accumulation_steps=3)
    ds, _ = T.build_device_dataset(data, torch.device("cpu"))
    return T, state, ds


def test_span_totals_and_self_time_on_nested_spans():
    """A span's self time is its time less its children's; outside a run
    spans and counters record nothing."""
    before = timing.records()
    with timing.span("outside"):
        timing.count("outside")
    with timing.run("t", units=1) as rec:
        with timing.span("outer"):
            for _ in range(2):
                with timing.span("inner"):
                    time.sleep(0.01)
            time.sleep(0.005)
        timing.count("things", 3)
        timing.count("things")
    assert _new_records(before) == [rec]
    assert rec.kind == "t" and rec.units == {"units": 1}
    assert not rec.profiled
    assert set(rec.spans) == {"outer", "inner"}
    assert rec.counts == {"things": 4}
    assert rec.n("outer") == 1 and rec.n("inner") == 2
    assert rec.host_s("inner") >= 0.02
    assert rec.self_s("inner") == rec.host_s("inner")
    assert rec.self_s("outer") == pytest.approx(
        rec.host_s("outer") - rec.host_s("inner"), abs=1e-12)
    assert rec.self_s("outer") >= 0.005


def test_record_list_is_bounded():
    n = timing.MAX_RECORDS + 3
    for i in range(n):
        with timing.run("t", i=i):
            pass
    kept = timing.records()
    assert len(kept) == timing.MAX_RECORDS
    assert [r.units["i"] for r in kept] == list(range(3, n))


def test_no_profiler_op_is_dispatched_without_a_profiler(monkeypatch):
    """With the profiler's range op made to raise, the spans of a walk
    rollout and a training pass run; under a profiler the same op is
    reached."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        refuse)
    with timing.run("t"):
        with timing.span("a"):
            pass
    _walk(1).run(n_poses=2, seed=3)
    T, state, ds = _training(rows=4)
    T.train_epoch_ds(state, ds, list(range(4)), random.Random(0),
                     micro_batch=2)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="profiler range"):
            with timing.span("a"):
                pass


def test_spans_are_profiler_ranges_on_the_profilers_clock():
    """Under a CPU profiler each span is a range of its name, nested as
    the spans are, whose length agrees with the record's within 5%."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.run("t") as rec:
            # Long enough that a few ms of the host's scheduling stay
            # within the 5%.
            with timing.span("outer"):
                with timing.span("inner"):
                    time.sleep(0.2)
                time.sleep(0.1)
    assert rec.profiled
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("outer", "inner"):
            assert e.name() not in ranges
            ranges[e.name()] = (e.start_ns() / 1e9, e.end_ns() / 1e9)
    (os_, oe), (is_, ie) = ranges["outer"], ranges["inner"]
    assert os_ <= is_ and ie <= oe
    assert oe - os_ == pytest.approx(rec.host_s("outer"), rel=0.05)
    assert ie - is_ == pytest.approx(rec.host_s("inner"), rel=0.05)


def test_walk_rollout_leaves_one_record():
    walk = _walk(2)
    before = timing.records()
    walk.run(n_poses=3, seed=5)
    (rec,) = _new_records(before)
    assert rec.kind == "rollout" and not rec.profiled
    assert rec.units == {"batch_poses": 3, "scenes": 2}
    assert set(WALK_SPANS) <= set(rec.spans)
    assert [rec.n(s) for s in WALK_SPANS] == [1, 1, 3, 3, 1]
    # Eight provider calls a scene a pose: two coverage, one direction,
    # one rotation and the four substeps' frames.
    assert rec.counts["draw_calls"] == 8 * 2 * 3
    # The CPU runs the step eagerly in plain PyTorch: no kernel launch.
    assert rec.counts["launches"] == 0
    children = sum(rec.host_s(s) for s in WALK_SPANS[1:])
    assert children <= rec.host_s("rollout")
    assert rec.self_s("rollout") == pytest.approx(
        rec.host_s("rollout") - children, abs=1e-9)


def test_training_pass_leaves_one_record():
    T, state, ds = _training(rows=6)
    before = timing.records()
    _, loss = T.train_epoch_ds(state, ds, list(range(6)), random.Random(0),
                               micro_batch=2)
    assert np.isfinite(loss)
    (rec,) = _new_records(before)
    assert rec.kind == "pass" and not rec.profiled
    assert rec.units == {"micro_steps": 3, "adamw_steps": 1, "rows": 6}
    assert {s: rec.n(s) for s in PASS_SPANS} == {
        "pass": 1, "shuffle": 1, "chunk": 3, "forward": 3, "batch": 3,
        "backward": 3, "accumulate": 3, "optimizer": 1, "loss_read": 1}
    assert rec.host_s("batch") <= rec.host_s("forward")
    assert rec.host_s("optimizer") <= rec.host_s("accumulate")
    top = ("shuffle", "chunk", "forward", "backward", "accumulate",
           "loss_read")
    assert sum(rec.host_s(s) for s in top) <= rec.host_s("pass")
