"""Flax NBP variables (as numpy) <-> the port's NBP ``state_dict``.

Takes and gives the nested ``params`` and ``batch_stats`` dicts of the JAX
package's ``NBP`` with numpy leaves (no flax needed here). Flax names its
modules ``<Type>_<n>`` in creation order; they are sorted by that numeric
suffix (``ConvBlock_10`` after ``ConvBlock_9``), which is the order of the
port's ``conv_blocks``, ``up_convs`` and ``att_gates``. Conv kernels go from
HWIO to OIHW and back. ``log_vars`` (the training loss's parameters) maps
to the port's ``log_vars`` both ways. A checkpoint loads into the port as
``load_checkpoint`` -> ``flax_to_state_dict`` -> ``load_state_dict``.

The SCONE models (``models/scone.py``) name their submodules as flax does,
so their maps go by name: a ``Dense`` kernel (in, out) becomes a
``Linear`` weight (out, in), a ``LayerNorm`` scale its weight, and back
(``scone_occ_from_flax`` / ``scone_occ_to_flax``, ``scone_vis_*``).

ManyDepth (``models/manydepth.py``) maps by name too, ``params`` and
``batch_stats`` together: a Conv kernel (HWIO) becomes an OIHW weight
(``ConvTranspose`` included: the port's is a correlation with the kernel
as stored), a BatchNorm ``scale``, ``bias``, ``mean`` and ``var`` its
``weight``, ``bias``, ``running_mean`` and ``running_var``, and back
(``manydepth_from_flax`` / ``manydepth_to_flax``).
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


def _named_from_flax(tree: Mapping, dtype, prefix: str = "",
                     out: Dict[str, torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    out = {} if out is None else out
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            _named_from_flax(leaf, dtype, f"{prefix}{name}.", out)
            continue
        arr = np.asarray(leaf, dtype)
        if name == "kernel":
            out[f"{prefix}weight"] = torch.from_numpy(np.array(arr.T,
                                                               order="C"))
        elif name in ("scale", "bias"):
            key = "weight" if name == "scale" else "bias"
            out[f"{prefix}{key}"] = torch.from_numpy(np.array(arr))
        else:
            raise KeyError(f"unexpected flax leaf {prefix}{name}")
    return out


def _named_to_flax(sd: Mapping[str, torch.Tensor], dtype) -> Dict:
    params: Dict = {}
    for key, t in sd.items():
        *path, leaf = key.split(".")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        arr = t.detach().cpu().numpy().astype(dtype)
        if leaf == "bias":
            node["bias"] = arr
        elif arr.ndim == 2:
            node["kernel"] = np.ascontiguousarray(arr.T)
        else:
            node["scale"] = arr
    return params


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def scone_occ_from_flax(params: Mapping, dtype: np.dtype = np.float32
                        ) -> Dict[str, torch.Tensor]:
    """State dict for ``models.scone.SconeOcc`` from its flax ``params``
    (or the whole variables dict)."""
    return _named_from_flax(_params(params), dtype)


def scone_occ_to_flax(sd: Mapping[str, torch.Tensor],
                      dtype: np.dtype = np.float32) -> Dict:
    """flax ``params`` of ``SconeOcc`` from the port's state dict."""
    return _named_to_flax(sd, dtype)


def scone_vis_from_flax(params: Mapping, dtype: np.dtype = np.float32
                        ) -> Dict[str, torch.Tensor]:
    """State dict for ``models.scone.SconeVis`` from its flax ``params``
    (or the whole variables dict)."""
    return _named_from_flax(_params(params), dtype)


def scone_vis_to_flax(sd: Mapping[str, torch.Tensor],
                      dtype: np.dtype = np.float32) -> Dict:
    """flax ``params`` of ``SconeVis`` from the port's state dict."""
    return _named_to_flax(sd, dtype)


_MD_STATS = {"mean": "running_mean", "var": "running_var"}


def manydepth_from_flax(variables: Mapping, dtype: np.dtype = np.float32
                        ) -> Dict[str, torch.Tensor]:
    """State dict for ``models.manydepth.ManyDepth`` from its flax
    variables (``params`` and ``batch_stats``, numpy leaves)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str, stats: bool) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{name}.", stats)
                continue
            arr = np.asarray(leaf, dtype)
            if stats:
                key = _MD_STATS[name]
            elif name == "kernel":
                key, arr = "weight", arr.transpose(3, 2, 0, 1)
            elif name in ("scale", "bias"):
                key = "weight" if name == "scale" else "bias"
            else:
                raise KeyError(f"unexpected flax leaf {prefix}{name}")
            out[f"{prefix}{key}"] = torch.from_numpy(np.array(arr, order="C"))

    walk(variables["params"], "", False)
    walk(variables.get("batch_stats", {}), "", True)
    return out


def manydepth_to_flax(sd: Mapping[str, torch.Tensor],
                      dtype: np.dtype = np.float32) -> Dict:
    """flax variables ``{"params", "batch_stats"}`` of ManyDepth from the
    port's state dict: the inverse of ``manydepth_from_flax``."""
    params: Dict = {}
    stats: Dict = {}
    inv = {v: k for k, v in _MD_STATS.items()}
    for key, t in sd.items():
        *path, leaf = key.split(".")
        arr = t.detach().cpu().numpy().astype(dtype)
        tree, name = params, leaf
        if leaf in inv:
            tree, name = stats, inv[leaf]
        elif leaf == "weight":
            if arr.ndim == 4:
                name, arr = "kernel", np.ascontiguousarray(
                    arr.transpose(2, 3, 1, 0))
            else:
                name = "scale"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = arr
    return {"params": params, "batch_stats": stats}
