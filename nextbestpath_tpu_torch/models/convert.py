"""Flax NBP variables (as numpy) <-> the port's NBP ``state_dict``.

Takes and gives the nested ``params`` and ``batch_stats`` dicts of the JAX
package's ``NBP`` with numpy leaves (no flax needed here). Flax names its
modules ``<Type>_<n>`` in creation order; they are sorted by that numeric
suffix (``ConvBlock_10`` after ``ConvBlock_9``), which is the order of the
port's ``conv_blocks``, ``up_convs`` and ``att_gates``. Conv kernels go from
HWIO to OIHW and back. ``log_vars`` (the training loss's parameters) maps
to the port's ``log_vars`` both ways. A checkpoint loads into the port as
``load_checkpoint`` -> ``flax_to_state_dict`` -> ``load_state_dict``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_BN_KEYS = (("scale", "weight"), ("bias", "bias"))
_STAT_KEYS = (("mean", "running_mean"), ("var", "running_var"))


def _by_suffix(tree: Mapping, prefix: str):
    pat = re.compile(rf"^{prefix}_(\d+)$")
    names = [k for k in tree if pat.match(k)]
    return sorted(names, key=lambda k: int(pat.match(k).group(1)))


def _conv(out: Dict, dst: str, conv: Mapping, dtype) -> None:
    kernel = np.asarray(conv["kernel"], dtype)              # (H, W, I, O)
    out[f"{dst}.weight"] = torch.from_numpy(
        np.array(kernel.transpose(3, 2, 0, 1), order="C"))
    out[f"{dst}.bias"] = torch.from_numpy(np.array(conv["bias"], dtype))


def _bn(out: Dict, dst: str, p: Mapping, s: Mapping, dtype) -> None:
    for src, name in _BN_KEYS:
        out[f"{dst}.{name}"] = torch.from_numpy(np.array(p[src], dtype))
    for src, name in _STAT_KEYS:
        out[f"{dst}.{name}"] = torch.from_numpy(np.array(s[src], dtype))
    out[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def flax_to_state_dict(params: Mapping, batch_stats: Mapping,
                       dtype: np.dtype = np.float32
                       ) -> Dict[str, torch.Tensor]:
    """State dict for ``models.unet.NBP`` from flax params/batch_stats,
    its tensors in ``dtype``."""
    out: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(_by_suffix(params, "ConvBlock")):
        p, s = params[name], batch_stats[name]
        for j in range(2):
            _conv(out, f"conv_blocks.{i}.conv{j}",
                  p[f"TorchConv_{j}"]["Conv_0"], dtype)
            _bn(out, f"conv_blocks.{i}.bn{j}", p[f"BatchNorm_{j}"],
                s[f"BatchNorm_{j}"], dtype)
    for i, name in enumerate(_by_suffix(params, "UpConv")):
        p, s = params[name], batch_stats[name]
        _conv(out, f"up_convs.{i}.conv", p["TorchConv_0"]["Conv_0"], dtype)
        _bn(out, f"up_convs.{i}.bn", p["BatchNorm_0"], s["BatchNorm_0"],
            dtype)
    for i, name in enumerate(_by_suffix(params, "AttentionGate")):
        p, s = params[name], batch_stats[name]
        for j, (conv, bn) in enumerate((("w_g", "bn_g"), ("w_x", "bn_x"),
                                        ("psi", "bn_psi"))):
            _conv(out, f"att_gates.{i}.{conv}",
                  p[f"TorchConv_{j}"]["Conv_0"], dtype)
            _bn(out, f"att_gates.{i}.{bn}", p[f"BatchNorm_{j}"],
                s[f"BatchNorm_{j}"], dtype)
    for head in ("final1", "final2"):
        _conv(out, head, params[head]["Conv_0"], dtype)
    out["log_vars"] = torch.from_numpy(np.array(
        params.get("log_vars", np.zeros(2, np.float32)), dtype))
    return out


def _module_names(sd: Mapping[str, torch.Tensor], group: str):
    idx = {int(k.split(".")[1]) for k in sd if k.startswith(group + ".")}
    return sorted(idx)


def state_dict_to_flax(sd: Mapping[str, torch.Tensor],
                       dtype: np.dtype = np.float32) -> Tuple[Dict, Dict]:
    """(params, batch_stats) with numpy leaves of ``dtype``, in flax's
    names, from an unfolded ``models.unet.NBP`` state_dict (or a dict of
    its gradients under the same names): the inverse of
    ``flax_to_state_dict``."""
    def arr(key):
        return sd[key].detach().cpu().numpy().astype(dtype)

    def conv(src):
        return {"Conv_0": {
            "kernel": np.ascontiguousarray(arr(f"{src}.weight")
                                           .transpose(2, 3, 1, 0)),
            "bias": arr(f"{src}.bias")}}

    def bn(src):
        return ({dst: arr(f"{src}.{name}") for dst, name in _BN_KEYS},
                {dst: arr(f"{src}.{name}") for dst, name in _STAT_KEYS})

    params: Dict = {}
    stats: Dict = {}
    blocks = (("conv_blocks", "ConvBlock", (("conv0", "bn0"),
                                            ("conv1", "bn1"))),
              ("up_convs", "UpConv", (("conv", "bn"),)),
              ("att_gates", "AttentionGate", (("w_g", "bn_g"), ("w_x", "bn_x"),
                                              ("psi", "bn_psi"))))
    for group, flax_name, pairs in blocks:
        for i in _module_names(sd, group):
            p, s = {}, {}
            for j, (c, b) in enumerate(pairs):
                p[f"TorchConv_{j}"] = conv(f"{group}.{i}.{c}")
                p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"] = bn(
                    f"{group}.{i}.{b}")
            params[f"{flax_name}_{i}"] = p
            stats[f"{flax_name}_{i}"] = s
    for head in ("final1", "final2"):
        params[head] = conv(head)
    params["log_vars"] = arr("log_vars")
    return params, stats
