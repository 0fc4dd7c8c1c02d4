"""Debug aids: NaN guards, gradient checks and loss-spike rollback.

Port of ``nextbestpath_tpu/utils/debugging.py`` (the reference's
``anomaly_detection`` config knob, ``check_gradients``,
macarons/utility/utils.py:188-198, and
``reload_previous_model_if_bad_loss`` with ``loss_peak_threshold``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Mapping, Tuple, Union

import numpy as np
import torch

NamedTensors = Union[Mapping[str, torch.Tensor],
                     Iterable[Tuple[str, torch.Tensor]]]


@contextlib.contextmanager
def anomaly_detection(enabled: bool = True):
    """Autograd's anomaly mode with its NaN check inside the block: a
    backward that makes a NaN raises, naming the forward op."""
    if not enabled:
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


def check_gradients(grads: NamedTensors, verbose: bool = True
                    ) -> Dict[str, float]:
    """Counts of NaN and all-zero gradients and the largest magnitude, over
    named tensors (a dict, or ``(name, tensor)`` pairs such as
    ``((n, p.grad) for n, p in model.named_parameters())``); None entries
    are skipped."""
    items = grads.items() if isinstance(grads, Mapping) else grads
    report = {"n_leaves": 0, "n_nan": 0, "n_zero": 0, "max_abs": 0.0}
    for name, g in items:
        if g is None:
            continue
        report["n_leaves"] += 1
        g = g.detach()
        if torch.isnan(g).any():
            report["n_nan"] += 1
            if verbose:
                print(f"NaN gradient at {name}")
        if (g == 0).all():
            report["n_zero"] += 1
        report["max_abs"] = max(report["max_abs"], float(g.abs().max()))
    return report


def _clone(state):
    if isinstance(state, torch.Tensor):
        return state.detach().clone()
    if isinstance(state, Mapping):
        return {k: _clone(v) for k, v in state.items()}
    return state


class BadLossGuard:
    """reload_previous_model_if_bad_loss: keep the last good state and roll
    back when the loss spikes above ``peak_threshold`` times the mean of
    the last 20 losses, after ``warmup`` losses. The kept state is a clone
    (a state dict's tensors are updated in place by the optimizer);
    ``update`` returns the state to carry on from and whether it rolled
    back, and the caller loads it (``model.load_state_dict``)."""

    def __init__(self, peak_threshold: float = 10.0, warmup: int = 10):
        self.peak_threshold = peak_threshold
        self.warmup = warmup
        self.history = []
        self.last_good = None

    def update(self, loss: float, state):
        if (len(self.history) >= self.warmup
                and loss > self.peak_threshold * np.mean(self.history[-20:])):
            return (self.last_good if self.last_good is not None
                    else state), True
        self.history.append(loss)
        self.last_good = _clone(state)
        return state, False
