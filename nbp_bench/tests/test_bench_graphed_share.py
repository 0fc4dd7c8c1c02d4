"""The reader of the program's graph counter, ``graphed_share.train``, on
hand-made run records: the share of a pass's micro steps that replayed
the captured micro step, and None without the counter."""

from types import SimpleNamespace

import pytest

from nbp_bench.common import BENCH_DIR, load_module
from nbp_bench.metrics import program_spans

READER = load_module(f"{BENCH_DIR}/metrics/graphed_share.train.py",
                     "nbp_metric_graphed_share_train")


def _pass(rows, replays=None, profiled=False):
    counts = {} if replays is None else {"graph_replays": replays}
    return SimpleNamespace(
        kind="pass", units={"micro_steps": rows // 8, "rows": rows},
        profiled=profiled, spans={"replay": [1, 0.001, 0.001]},
        counts=counts)


def test_graphed_share_reads_replays_over_micro_steps(monkeypatch):
    """Of a set-up pass of another size, two of the cell's size (70 and 69
    of 70 micro steps replayed), a profiled one and a later one, the
    median reads the two."""
    monkeypatch.setattr(program_spans, "_records", lambda: [
        _pass(56, 5), _pass(560, 70), _pass(560, 69),
        _pass(560, 0, profiled=True), _pass(560, 10)])
    layer = {"passes": [{"samples": 560}]}
    assert READER.read(layer) == pytest.approx(100.0 * (70 + 69) / 140)


def test_graphed_share_is_none_without_the_counter(monkeypatch):
    """A program that keeps no graph counter (the eager step) gives
    None, which the result line leaves out."""
    monkeypatch.setattr(program_spans, "_records", lambda: [
        _pass(56), _pass(560), _pass(560)])
    assert READER.read({"passes": [{"samples": 560}]}) is None
