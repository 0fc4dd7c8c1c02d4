"""Point-cloud attention blocks as ``nn.Module``s.

Port of ``nextbestpath_tpu/models/attention.py`` (itself the reference's
Attention.py) with its quirks:

* attention scores are filled with -1e3 where the mask is 0 BEFORE the
  1/sqrt(d) scaling;
* ``Embedding`` derives its inner and feature widths by subtracting the
  global-feature, additional-feature and raw-input concatenations;
* ``MultiHeadSelfAttention`` applies its output projection only when
  n_heads > 1;
* ``Encoder`` is a pre-LayerNorm residual block with an optional
  ``FeedForward``.

flax's defaults are kept: GELU is the tanh approximation, LayerNorm's
epsilon is 1e-6 and its variance is E[x^2] - E[x]^2. Submodules carry
flax's names (``Dense_0``, ``LayerNorm_1``, ...), given in flax's creation
order, so ``models/convert.py`` maps a flax tree onto a ``state_dict`` by
name. In ``FeedForward`` flax creates the OUTER layer first, so
``Dense_0`` is the outer layer and ``Dense_1`` the inner one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.knn import gather_rows, knn_indices


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def activation(use_gelu: bool):
    return gelu if use_gelu else F.relu


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: epsilon 1e-6, the
    variance as max(E[x^2] - E[x]^2, 0), then (x - mean) * (rsqrt(var +
    eps) * scale) + bias."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


def attention(q, k, v, mask=None):
    scores = torch.matmul(q, k.transpose(-1, -2))
    if mask is not None:
        scores = torch.where(mask == 0, torch.full_like(scores, -1e3), scores)
    scores = scores / math.sqrt(q.shape[-1])
    scores = torch.softmax(scores, dim=-1)
    return torch.matmul(scores, v)


class Embedding(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, gelu: bool = True,
                 global_feature: bool = False,
                 additional_feature_dim: int = 0,
                 concatenate_input: bool = True, k_for_knn: int = 0):
        super().__init__()
        feature_dim = output_dim
        if additional_feature_dim > 0:
            feature_dim -= additional_feature_dim
        if concatenate_input:
            feature_dim -= input_dim
        if global_feature:
            feature_dim //= 2
        inner_dim = feature_dim if (additional_feature_dim > 0
                                    or concatenate_input
                                    or global_feature) else output_dim // 2
        self.act = activation(gelu)
        self.global_feature = global_feature
        self.additional_feature_dim = additional_feature_dim
        self.concatenate_input = concatenate_input
        self.k_for_knn = k_for_knn
        self.Dense_0 = nn.Linear(input_dim, inner_dim)
        self.Dense_1 = nn.Linear(inner_dim, feature_dim)

    def forward(self, x, additional_feature=None):
        res = self.Dense_1(self.act(self.Dense_0(x)))
        if self.k_for_knn > 0:
            idx = knn_indices(x[..., :3], x[..., :3], self.k_for_knn)
            res = gather_rows(res, idx).amax(dim=-2)
        if self.global_feature:
            g = res.amax(dim=-2, keepdim=True)
            res = torch.cat([res, g.expand(res.shape)], dim=-1)
        if self.additional_feature_dim > 0:
            res = torch.cat([res, additional_feature], dim=-1)
        if self.concatenate_input:
            res = torch.cat([res, x], dim=-1)
        return res


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, n_heads: int, in_dim: int, qk_dim: int):
        super().__init__()
        self.n_heads, self.in_dim, self.qk_dim = n_heads, in_dim, qk_dim
        self.Dense_0 = nn.Linear(in_dim, qk_dim)
        self.Dense_1 = nn.Linear(in_dim, qk_dim)
        self.Dense_2 = nn.Linear(in_dim, in_dim)
        if n_heads > 1:
            self.Dense_3 = nn.Linear(in_dim, in_dim)

    def forward(self, x, mask=None):
        B, h = x.shape[0], self.n_heads
        q = self.Dense_0(x).reshape(B, -1, h, self.qk_dim // h).transpose(1, 2)
        k = self.Dense_1(x).reshape(B, -1, h, self.qk_dim // h).transpose(1, 2)
        v = self.Dense_2(x).reshape(B, -1, h, self.in_dim // h).transpose(1, 2)
        scores = attention(q, k, v, mask)
        scores = scores.transpose(1, 2).reshape(B, -1, self.in_dim)
        if self.n_heads > 1:
            scores = self.Dense_3(scores)
        return scores


class FeedForward(nn.Module):
    def __init__(self, input_dim: int, inner_dim: int, gelu: bool = True):
        super().__init__()
        self.act = activation(gelu)
        self.Dense_0 = nn.Linear(inner_dim, input_dim)  # the outer layer
        self.Dense_1 = nn.Linear(input_dim, inner_dim)

    def forward(self, x):
        return self.Dense_0(self.act(self.Dense_1(x)))


class Encoder(nn.Module):
    def __init__(self, embedding_dim: int, qk_dim: int, n_heads: int = 1,
                 gelu: bool = True, use_ff: bool = True):
        super().__init__()
        self.use_ff = use_ff
        self.LayerNorm_0 = LayerNorm(embedding_dim)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            n_heads, embedding_dim, qk_dim)
        if use_ff:
            self.LayerNorm_1 = LayerNorm(embedding_dim)
            self.FeedForward_0 = FeedForward(embedding_dim, 2 * embedding_dim,
                                             gelu=gelu)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        res = x + self.MultiHeadSelfAttention_0(self.LayerNorm_0(x),
                                                mask=mask)
        if self.use_ff:
            res = res + self.FeedForward_0(self.LayerNorm_1(res))
        return res
