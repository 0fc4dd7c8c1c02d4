"""ManyDepth self-supervised multi-frame depth network as a PyTorch module.

Port of ``nextbestpath_tpu/models/manydepth.py`` (the reference's
macarons/networks/ManyDepth.py constants: 256x456 input, depth in
[0.5, 750], 96 cost-volume planes, pose factor 100). The module computes
in NCHW and takes and returns NHWC at its boundary, as the JAX package's
layouts:

    forward(x (B, H, W, 3), R, T, x_alpha (B, A, H, W, 3), R_alpha,
            T_alpha) -> (disp1 (B, H, W, 1), disp2 H/2, disp3 H/4, disp4 H/8)

* ``FeatureExtractor``: the ResNet-18 stem and layer1, 64 channels at H/4.
* ``CostVolumeBuilder``: the plane sweep. Each target pixel is unprojected
  at each of the 96 depth planes, projected into each context (alpha)
  camera and its features sampled bilinearly (``_warp_features``: all
  channels from one set of corner indices, zeros outside the frame and
  behind the camera); the mean over alphas against the target features,
  mean absolute difference over channels, is the cost of the plane. The
  96 planes are one batched computation, not a loop.
* ``ExpansionLayer``: flax's ``ConvTranspose`` at stride 1 with ``SAME``
  padding and ``transpose_kernel=False`` is a plain correlation with the
  kernel as stored, so it is a ``Conv`` here (not ``ConvTranspose2d``,
  which flips the kernel); then ``jax.image.resize(..., "nearest")``,
  whose half-pixel centres are torch's ``"nearest-exact"``.
* ``PoseDecoder`` (``learn_pose=True``): the relative pose of each context
  frame, composed with the target camera.

Submodules carry flax's names, so ``models/convert.py::manydepth_from_flax``
maps a flax tree by name. ``forward(..., train=False)`` is flax's ``train``:
BatchNorm's eval mode by default (the online trainer's), and with
``train=True`` the batch statistics (``models/resnet.py``; the depth
pretrainer's). Then ``stem`` and ``layer1`` run twice, on the targets and
then on the B A context frames, each call normalising by its own batch and
moving the running statistics in place, target first (as do the pose
decoder's A calls with ``learn_pose``): the module's buffers after the
forward are the ``batch_stats`` that flax's ``mutable`` returns. On the
card the network runs in full f32: callers put it under
``device.py::full_f32`` (cuDNN and matmul TF32 off).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry.cameras import (CameraIntrinsics, _mat3, camera_center,
                                project_points)
from ..ops.depth_sample import grid_sample_bilinear
from .resnet import Conv, ResNetLayer, ResNetStem, maxpool_stem

D_MIN = 0.5
D_MAX = 750.0
N_DEPTH = 96
POSE_FACTOR = 100.0


def disparity_to_depth(disp, d_min: float = D_MIN, d_max: float = D_MAX):
    """depth = 1 / (a disp + b), a = 1/d_min - 1/d_max, b = 1/d_max."""
    a = 1.0 / d_min - 1.0 / d_max
    b = 1.0 / d_max
    return 1.0 / (a * disp + b)


def depth_to_disparity(depth, d_min: float = D_MIN, d_max: float = D_MAX):
    a = 1.0 / d_min - 1.0 / d_max
    b = 1.0 / d_max
    return (1.0 / depth - b) / a


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class FeatureExtractor(nn.Module):
    """Standalone stem + layer1 (ManyDepth inlines the same stack, as it
    also needs the stem's output as a decoder skip)."""

    def __init__(self):
        super().__init__()
        self.ResNetStem_0 = ResNetStem()
        self.ResNetLayer_0 = ResNetLayer(64, 64, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x (B, 3, H, W) -> (B, 64, H/4, W/4)."""
        return self.ResNetLayer_0(maxpool_stem(self.ResNetStem_0(x, train)),
                                  train)


def _warp_features(world_points: torch.Tensor, features: torch.Tensor,
                   R: torch.Tensor, T: torch.Tensor, intr: CameraIntrinsics,
                   padding: str = "zeros") -> torch.Tensor:
    """Sample ``features`` (h, w, C) at the projections of world_points
    (..., 3) through camera (R, T): (..., C). The grid is the reference's
    (factor -min(h, w)); ``zeros`` zeroes samples outside [-1, 1] and
    behind the camera (the cost volume's mode), ``border`` clamps (the
    reconstruction loss's mode)."""
    h, w = features.shape[:2]
    proj = project_points(world_points, R, T, intr.tan_half_fov)
    factor = -float(min(h, w))
    gx = factor / w * proj[..., 0]
    gy = factor / h * proj[..., 1]
    sampled = grid_sample_bilinear(features, gx, gy)
    if padding == "border":
        return sampled
    inside = (torch.abs(gx) <= 1.0) & (torch.abs(gy) <= 1.0) & (
        proj[..., 2] > 0.0)
    return sampled * inside[..., None]


class CostVolumeBuilder(nn.Module):
    """Plane-sweep cost volume at feature resolution (H/4, W/4)."""

    def __init__(self, intr: CameraIntrinsics, n_depth: int = N_DEPTH,
                 d_min: float = D_MIN, d_max: float = D_MAX,
                 output_channels: int = 64):
        super().__init__()
        self.intr = intr
        self.n_depth = n_depth
        self.d_min, self.d_max = d_min, d_max
        self.Conv_0 = Conv(64 + n_depth, output_channels, 3)

    def cost_volume(self, feats: torch.Tensor, R: torch.Tensor,
                    T: torch.Tensor, feats_alpha: torch.Tensor,
                    R_alpha: torch.Tensor, T_alpha: torch.Tensor
                    ) -> torch.Tensor:
        """feats (B, h, w, C); feats_alpha (B, A, h, w, C) with cameras
        R_alpha (B, A, 3, 3), T_alpha (B, A, 3) -> (B, h, w, n_depth)."""
        B, h, w, C = feats.shape
        intr = self.intr
        fh = CameraIntrinsics(image_height=h, image_width=w,
                              fov_degrees=intr.fov_degrees, znear=intr.znear,
                              zfar=intr.zfar)
        dt, dev = feats.dtype, feats.device
        d_view = fh.pixel_ray_dirs_view(dev).reshape(-1, 3).to(dt)
        bins = torch.linspace(self.d_min, self.d_max, self.n_depth,
                              dtype=dt, device=dev)
        out = []
        for b in range(B):
            eye = camera_center(R[b], T[b])
            d_world = _mat3(d_view, R[b].T)
            # (n_depth, h*w, 3): every plane's world points at once.
            wp = eye + bins[:, None, None] * d_world[None]
            warped = torch.stack([
                _warp_features(wp, feats_alpha[b, a], R_alpha[b, a],
                               T_alpha[b, a], fh)
                for a in range(feats_alpha.shape[1])])
            mean_w = warped.mean(dim=0).reshape(self.n_depth, h, w, C)
            cv = torch.abs(mean_w - feats[b][None]).sum(dim=-1) / C
            out.append(cv.permute(1, 2, 0))
        return torch.stack(out)

    def forward(self, feats, R, T, feats_alpha, R_alpha, T_alpha,
                return_cost_volume: bool = False):
        """NHWC in, as ``cost_volume``; -> (B, 64, h, w) NCHW features
        (and the (B, h, w, n_depth) cost volume when asked)."""
        cv = self.cost_volume(feats, R, T, feats_alpha, R_alpha, T_alpha)
        res = torch.relu(self.Conv_0(nchw(torch.cat([feats, cv], dim=-1))))
        if return_cost_volume:
            return res, cv
        return res


class ExpansionLayer(nn.Module):
    def __init__(self, cin: int, inner_channels: int, output_channels: int,
                 output_size: Tuple[int, int], add_channels: int = 0):
        super().__init__()
        self.output_size = tuple(output_size)
        self.ConvTranspose_0 = Conv(cin, inner_channels, 3)
        self.Conv_0 = Conv(inner_channels + add_channels, output_channels, 3)

    def forward(self, x: torch.Tensor,
                x_add: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.elu(self.ConvTranspose_0(x))
        x = F.interpolate(x, size=self.output_size, mode="nearest-exact")
        if x_add is not None:
            x = torch.cat([x, x_add], dim=1)
        return F.elu(self.Conv_0(x))


class DisparityLayer(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.Conv_0 = Conv(cin, 1, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.Conv_0(x))


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    axis = aa / torch.clamp(theta, min=1e-12)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    return eye + s * K + (1 - c) * torch.matmul(K, K)


class PoseDecoder(nn.Module):
    """6-DoF relative pose of a target/source frame pair: a ResNet-style
    encoder over the 6-channel concat, squeeze convolutions, the spatial
    mean scaled by 0.01 -> (axis-angle, translation)."""

    def __init__(self):
        super().__init__()
        self.stem = ResNetStem(6)
        self.ResNetLayer_0 = ResNetLayer(64, 64, 1)
        self.ResNetLayer_1 = ResNetLayer(64, 128, 2)
        self.Conv_0 = Conv(128, 256, 1)
        self.Conv_1 = Conv(256, 256, 3)
        self.Conv_2 = Conv(256, 6, 1)

    def forward(self, target: torch.Tensor, source: torch.Tensor,
                train: bool = False):
        """target, source (B, 3, H, W) -> ((B, 3), (B, 3))."""
        x = torch.cat([target, source], dim=1)
        x = maxpool_stem(self.stem(x, train))
        x = self.ResNetLayer_1(self.ResNetLayer_0(x, train), train)
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        out = self.Conv_2(x).mean(dim=(2, 3)) * 0.01
        return out[..., :3], out[..., 3:]

    @staticmethod
    def compose(R, T, axisangle, translation,
                pose_factor: float = POSE_FACTOR):
        """Target camera (R, T) and a relative pose -> the source camera
        (row vectors: R_src = R R_rel, T_src = T R_rel + t pose_factor)."""
        R_rel = axis_angle_to_matrix(axisangle)
        t = translation * pose_factor
        R_src = torch.matmul(R, R_rel)
        T_src = torch.matmul(T[..., None, :], R_rel)[..., 0, :] + t
        return R_src, T_src


def _ceil_div(n: int, d: int) -> int:
    return n // d + (1 if n % d else 0)


class ManyDepth(nn.Module):
    """Full depth network: (images, poses) -> 4-scale disparities."""

    def __init__(self, intr: CameraIntrinsics = CameraIntrinsics(
                     image_height=256, image_width=456),
                 n_depth: int = N_DEPTH, d_min: float = D_MIN,
                 d_max: float = D_MAX, use_input_image_in_skip: bool = True,
                 learn_pose: bool = False):
        super().__init__()
        self.intr = intr
        self.learn_pose = learn_pose
        self.use_input_image_in_skip = use_input_image_in_skip
        H, W = intr.image_height, intr.image_width

        def size(div):
            return (_ceil_div(H, div), _ceil_div(W, div))

        if learn_pose:
            self.pose_decoder = PoseDecoder()
        self.stem = ResNetStem()
        self.layer1 = ResNetLayer(64, 64, 1)
        self.cost_volume = CostVolumeBuilder(intr, n_depth, d_min, d_max)
        self.ResNetLayer_0 = ResNetLayer(64, 128, 2)
        self.ResNetLayer_1 = ResNetLayer(128, 256, 2)
        self.ResNetLayer_2 = ResNetLayer(256, 512, 2)
        self.ExpansionLayer_0 = ExpansionLayer(512, 256, 256, size(16), 256)
        self.ExpansionLayer_1 = ExpansionLayer(256, 128, 128, size(8), 128)
        self.DisparityLayer_0 = DisparityLayer(128)
        self.ExpansionLayer_2 = ExpansionLayer(128, 64, 64, size(4), 64)
        self.DisparityLayer_1 = DisparityLayer(64)
        self.ExpansionLayer_3 = ExpansionLayer(64, 32, 32, size(2), 64)
        self.DisparityLayer_2 = DisparityLayer(32)
        self.ExpansionLayer_4 = ExpansionLayer(
            32, 16, 16, (H, W), 3 if use_input_image_in_skip else 0)
        self.DisparityLayer_3 = DisparityLayer(16)

    def forward(self, x: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                x_alpha: torch.Tensor, R_alpha: Optional[torch.Tensor] = None,
                T_alpha: Optional[torch.Tensor] = None, train: bool = False):
        B, H, W, _ = x.shape
        A = x_alpha.shape[1]
        xc = nchw(x)
        xa = nchw(x_alpha.reshape(B * A, H, W, 3))
        if R_alpha is None or T_alpha is None:
            if not self.learn_pose:
                raise ValueError("R_alpha/T_alpha required when "
                                 "learn_pose=False")
            xa5 = xa.reshape(B, A, 3, H, W)
            pairs = [self.pose_decoder(xc, xa5[:, i], train)
                     for i in range(A)]
            aas = torch.stack([p[0] for p in pairs], dim=1)
            trs = torch.stack([p[1] for p in pairs], dim=1)
            R_alpha, T_alpha = PoseDecoder.compose(R[:, None], T[:, None],
                                                   aas, trs)
        conv1 = self.stem(xc, train)
        feats = self.layer1(maxpool_stem(conv1), train)
        feats_a = self.layer1(maxpool_stem(self.stem(xa, train)), train)
        h, w = feats.shape[-2:]
        feats_a = nhwc(feats_a).reshape(B, A, h, w, 64)

        reduced = self.cost_volume(nhwc(feats), R, T, feats_a, R_alpha,
                                   T_alpha)
        layer2 = self.ResNetLayer_0(reduced, train)
        layer3 = self.ResNetLayer_1(layer2, train)
        layer4 = self.ResNetLayer_2(layer3, train)
        iconv5 = self.ExpansionLayer_0(layer4, layer3)
        iconv4 = self.ExpansionLayer_1(iconv5, layer2)
        disp4 = self.DisparityLayer_0(iconv4)
        iconv3 = self.ExpansionLayer_2(iconv4, feats)
        disp3 = self.DisparityLayer_1(iconv3)
        iconv2 = self.ExpansionLayer_3(iconv3, conv1)
        disp2 = self.DisparityLayer_2(iconv2)
        iconv1 = self.ExpansionLayer_4(
            iconv2, xc if self.use_input_image_in_skip else None)
        disp1 = self.DisparityLayer_3(iconv1)
        return tuple(nhwc(d) for d in (disp1, disp2, disp3, disp4))


def flax_init_(model: nn.Module, seed: int = 0) -> nn.Module:
    """flax's initialisers in place, from ``seed``: every convolution
    kernel LeCun-normal (a normal truncated at 2 sigma, scaled to variance
    1 / fan_in), every bias 0; BatchNorm scale 1, bias 0, mean 0, var 1.
    The truncated normal is drawn by rejection with numpy."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                w = rng.standard_normal(m.weight.numel(), dtype=np.float32)
                bad = np.abs(w) > 2.0
                while bad.any():
                    w[bad] = rng.standard_normal(int(bad.sum()),
                                                 dtype=np.float32)
                    bad = np.abs(w) > 2.0
                std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                m.weight.copy_(torch.from_numpy(w * np.float32(std))
                               .reshape(m.weight.shape))
                if m.bias is not None:
                    m.bias.zero_()
    return model
