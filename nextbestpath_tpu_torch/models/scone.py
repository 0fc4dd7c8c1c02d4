"""SCONE occupancy and visibility networks as ``nn.Module``s.

Port of ``nextbestpath_tpu/models/scone.py`` (the reference's SconeOcc.py
and SconeVis.py):

* ``XEmbedding``: a 3-layer GELU MLP embedding of the query points;
* ``PCTransformer``: point embedding, n_code pre-LN self-attention
  encoders, LayerNorm and Dense, then concat(max-pool, mean-pool): a global
  feature a cloud;
* ``SconeOcc``: a global transformer on a <= seq_len random downsample,
  n_scale local kNN transformers on progressively downsampled clouds
  (offset coordinates), the query embedding and the 64-d view harmonics,
  into a 3-layer GELU head;
* ``SconeVis``: embedding (with a global feature), n_code encoders and an
  MLP -> 64 spherical-harmonic coefficients a point;
* ``visibility_gains`` / ``coverage_gain``: the harmonics evaluated toward
  candidate cameras (sigmoid), summed over the points.

The defaults are the published widths. The random downsampling's
permutations come from a draws provider (``draws.py``): the global one as
``permutation(role, N)``, scale s's as ``permutation(role, n_s, step=s)``
(the JAX package's ``permutation(k_global, N)`` and
``permutation(fold_in(k_ds, s), n_s)`` of one key's split).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..draws import TorchDraws
from ..geometry.spherical import get_spherical_coords
from ..ops.knn import knn_points
from .attention import Embedding, Encoder, LayerNorm, activation, gelu
from .harmonics import harmonics_up_to_rank


class XEmbedding(nn.Module):
    def __init__(self, x_embedding_dim: int = 512, gelu: bool = True):
        super().__init__()
        d = x_embedding_dim
        self.act = activation(gelu)
        self.Dense_0 = nn.Linear(3, d // 4)
        self.Dense_1 = nn.Linear(d // 4, d // 2)
        self.Dense_2 = nn.Linear(d // 2, d)

    def forward(self, x):
        res = self.act(self.Dense_0(x))
        res = self.act(self.Dense_1(res))
        return self.act(self.Dense_2(res))


class PCTransformer(nn.Module):
    def __init__(self, pts_dim: int = 3, pts_embedding_dim: int = 256,
                 feature_dim: int = 512, concatenate_input: bool = True,
                 n_code: int = 2, n_heads: int = 4, use_ff: bool = True,
                 gelu: bool = True):
        super().__init__()
        self.feature_dim = feature_dim
        self.n_code = n_code
        self.Embedding_0 = Embedding(pts_dim, pts_embedding_dim, gelu=gelu,
                                     concatenate_input=concatenate_input)
        for i in range(n_code):
            setattr(self, f"Encoder_{i}", Encoder(
                pts_embedding_dim, pts_embedding_dim // 4, n_heads=n_heads,
                gelu=gelu, use_ff=use_ff))
        self.LayerNorm_0 = LayerNorm(pts_embedding_dim)
        self.Dense_0 = nn.Linear(pts_embedding_dim, feature_dim // 2)

    def forward(self, pc, mask=None):
        x = self.Embedding_0(pc)
        for i in range(self.n_code):
            x = getattr(self, f"Encoder_{i}")(x, mask=mask)
        feats = self.Dense_0(self.LayerNorm_0(x))
        pooled = torch.cat([feats.amax(dim=1), feats.mean(dim=1)], dim=-1)
        return pooled.reshape(pc.shape[0], self.feature_dim)


class SconeOcc(nn.Module):
    """Occupancy-probability implicit field."""

    def __init__(self, seq_len: int = 2048, pts_dim: int = 3,
                 pts_embedding_dim: int = 128, concatenate_input: bool = True,
                 n_code: int = 2, n_heads: int = 4, use_ff: bool = True,
                 gelu: bool = True, global_feature_dim: int = 512,
                 n_scale: int = 3, local_feature_dim: int = 256,
                 k_for_knn: int = 16, x_embedding_dim: int = 512,
                 n_harmonics: int = 64, output_dim: int = 1):
        super().__init__()
        self.seq_len = seq_len
        self.global_feature_dim = global_feature_dim
        self.n_scale = n_scale
        self.local_feature_dim = local_feature_dim
        self.k_for_knn = k_for_knn
        self.output_dim = output_dim
        self.act = activation(gelu)
        tf = dict(pts_dim=pts_dim, pts_embedding_dim=pts_embedding_dim,
                  concatenate_input=concatenate_input, n_code=n_code,
                  n_heads=n_heads, use_ff=use_ff, gelu=gelu)
        self.PCTransformer_0 = PCTransformer(feature_dim=global_feature_dim,
                                             **tf)
        for s in range(n_scale):
            setattr(self, f"PCTransformer_{1 + s}",
                    PCTransformer(feature_dim=local_feature_dim, **tf))
        self.XEmbedding_0 = XEmbedding(x_embedding_dim, gelu=gelu)
        head_in = (global_feature_dim + n_scale * local_feature_dim
                   + x_embedding_dim + n_harmonics)
        self.Dense_0 = nn.Linear(head_in, 512)
        self.Dense_1 = nn.Linear(512, 256)
        self.Dense_2 = nn.Linear(256, output_dim)

    def ds_factor(self, full_seq_len: int) -> int:
        """The local scales' downsampling factor, as the JAX package
        computes it (np.power, cast to int, at least 2)."""
        if self.n_scale <= 1:
            return 1
        f = int(np.power(full_seq_len / (self.k_for_knn * 8),
                         1.0 / (self.n_scale - 1)))
        return max(f, 2)

    def forward(self, pc, x, view_harmonics, draws=None, role: str = "occ"):
        """pc (B, N, 3), x (B, M, 3), view_harmonics (B, M, n_harmonics)
        -> (B, M, output_dim). ``draws`` serves the permutations (default:
        a ``TorchDraws`` seeded 0 on pc's device)."""
        if draws is None:
            draws = TorchDraws(0, pc.device)
        n_clouds, full_seq_len = pc.shape[0], pc.shape[1]
        n_sample = x.shape[1]
        dev = pc.device

        take = min(self.seq_len, full_seq_len)
        perm = draws.permutation(role, full_seq_len).to(dev)[:take]
        global_features = self.PCTransformer_0(pc[:, perm])

        ds_factor = self.ds_factor(full_seq_len)
        down_pc = pc
        locals_ = []
        for s in range(self.n_scale):
            nbrs, _ = knn_points(x, down_pc, self.k_for_knn)
            local_pc = nbrs - x[:, :, None, :]  # offset coordinates
            feats = getattr(self, f"PCTransformer_{1 + s}")(
                local_pc.reshape(-1, self.k_for_knn, 3))
            locals_.append(feats)
            if s < self.n_scale - 1:
                n_down = down_pc.shape[1]
                ds_len = max(n_down // ds_factor, self.k_for_knn)
                perm = draws.permutation(role, n_down, step=s).to(dev)[:ds_len]
                down_pc = down_pc[:, perm]

        local_features = torch.cat(locals_, dim=-1).reshape(
            n_clouds, n_sample, self.n_scale * self.local_feature_dim)
        x_features = self.XEmbedding_0(x)
        g = global_features[:, None, :].expand(n_clouds, n_sample,
                                               self.global_feature_dim)
        res = torch.cat([g, local_features, x_features, view_harmonics],
                        dim=-1)
        res = self.act(self.Dense_0(res))
        res = self.act(self.Dense_1(res))
        res = self.act(self.Dense_2(res))
        return res.reshape(n_clouds, n_sample, self.output_dim)


class SconeVis(nn.Module):
    """Visibility-gain field as spherical harmonics."""

    def __init__(self, pts_dim: int = 4, pts_embedding_dim: int = 256,
                 n_heads: int = 4, n_code: int = 3, n_harmonics: int = 64,
                 max_harmonic_rank: int = 8, use_ff: bool = True,
                 gelu: bool = True, use_view_state: bool = True,
                 use_global_feature: bool = True,
                 view_state_mode: str = "end",
                 concatenate_input: bool = True, use_sigmoid: bool = True):
        super().__init__()
        self.n_code = n_code
        self.n_harmonics = n_harmonics
        self.max_harmonic_rank = max_harmonic_rank
        self.use_sigmoid = use_sigmoid
        self.vs_start = use_view_state and view_state_mode == "start"
        self.vs_end = use_view_state and view_state_mode == "end"
        add_dim = n_harmonics if self.vs_start else 0
        self.Embedding_0 = Embedding(pts_dim, pts_embedding_dim, gelu=gelu,
                                     global_feature=use_global_feature,
                                     additional_feature_dim=add_dim,
                                     concatenate_input=concatenate_input)
        for i in range(n_code):
            setattr(self, f"Encoder_{i}", Encoder(
                pts_embedding_dim, pts_embedding_dim // 4, n_heads=n_heads,
                gelu=gelu, use_ff=use_ff))
        self.LayerNorm_0 = LayerNorm(pts_embedding_dim)
        inner = 3 if self.vs_end else 4
        self.Dense_0 = nn.Linear(pts_embedding_dim, inner * n_harmonics)
        self.Dense_1 = nn.Linear(
            inner * n_harmonics + (n_harmonics if self.vs_end else 0),
            2 * n_harmonics)
        self.Dense_2 = nn.Linear(2 * n_harmonics, n_harmonics)

    def forward(self, pts, mask=None, view_harmonics=None):
        """pts (B, N, pts_dim), view_harmonics (B, N, n_harmonics) ->
        harmonics (B, N, n_harmonics)."""
        x = self.Embedding_0(
            pts, additional_feature=view_harmonics if self.vs_start else None)
        for i in range(self.n_code):
            x = getattr(self, f"Encoder_{i}")(x, mask=mask)
        res = gelu(self.Dense_0(self.LayerNorm_0(x)))
        if self.vs_end:
            res = torch.cat([res, view_harmonics], dim=-1)
        res = gelu(self.Dense_1(res))
        return self.Dense_2(res).reshape(pts.shape[0], pts.shape[1],
                                         self.n_harmonics)


def visibility_gains(pts: torch.Tensor, harmonics: torch.Tensor,
                     X_cam: torch.Tensor, max_rank: int = 8,
                     use_sigmoid: bool = True) -> torch.Tensor:
    """Each point's visibility toward each candidate camera: pts (B, N,
    >=3), harmonics (B, N, n_harm), X_cam (B, C, 3) -> (B, C, N)."""
    rays = X_cam[:, :, None, :] - pts[:, None, :, :3]
    _, elev, azim = get_spherical_coords(rays)
    theta = -elev + math.pi / 2.0
    z = harmonics_up_to_rank(max_rank, theta, azim)  # (B, C, N, n_harm)
    z = (z * harmonics[:, None, :, :]).sum(dim=-1)
    return torch.sigmoid(z) if use_sigmoid else torch.relu(z)


def coverage_gain(pts: torch.Tensor, harmonics: torch.Tensor,
                  X_cam: torch.Tensor, max_rank: int = 8,
                  use_sigmoid: bool = True,
                  fov_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coverage gain a candidate camera, (B, C): the visibility summed over
    the points (those in ``fov_mask`` (B, C, N) when given) over the point
    count, so masked and unmasked gains share a scale."""
    vis = visibility_gains(pts, harmonics, X_cam, max_rank, use_sigmoid)
    if fov_mask is not None:
        vis = vis * fov_mask
    return vis.sum(dim=-1) / pts.shape[1]
