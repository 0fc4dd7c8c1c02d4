"""The reader of the program's draw counters, ``kernel_draw_share.nbv``,
on hand-made ``nbv`` run records: the share of the candidates drawn whose
tokens the kernel drew, and None without the counters."""

from types import SimpleNamespace

import pytest

from nbp_bench.common import BENCH_DIR, load_module

READER = load_module(f"{BENCH_DIR}/metrics/kernel_draw_share.nbv.py",
                     "nbp_metric_kernel_draw_share_nbv")


def _rollout(token_draws=None, kernel_draws=None, poses=101):
    counts = {"vis_tokens": 20 * 2048 * poses}
    if token_draws is not None:
        counts["token_draws"] = token_draws
    if kernel_draws is not None:
        counts["kernel_draws"] = kernel_draws
    return {"s": 6.0, "poses": poses, "scene": 0,
            "record": SimpleNamespace(kind="nbv", units={"poses": poses},
                                      spans={}, counts=counts)}


def test_kernel_draw_share_reads_kernel_over_token_draws():
    """Of three rollouts, every candidate, all but one pose's and none
    drawn by the kernel, the median reads the middle one."""
    layer = {"rollouts": [_rollout(2020, 2020), _rollout(2020, 2000),
                          _rollout(2020, None)]}
    assert READER.read(layer) == pytest.approx(100.0 * 2000 / 2020)
    layer = {"rollouts": [_rollout(2020, 2020), _rollout(2020, 2020)]}
    assert READER.read(layer) == 100.0


def test_kernel_draw_share_is_none_without_the_counter():
    """A program that keeps no draw counters (the parent of the kernel),
    or no records, gives None, which the result line leaves out."""
    assert READER.read({"rollouts": [_rollout(), _rollout()]}) is None
    assert READER.read({"rollouts": [dict(_rollout(2020, 2020),
                                          record=None)]}) is None
    assert READER.read({}) is None
