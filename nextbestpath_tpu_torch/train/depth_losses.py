"""Self-supervised depth losses (photometric + smoothness + error mask).

Port of ``nextbestpath_tpu/train/depth_losses.py``:

* SSIM with a 5x5 gaussian window (sigma 1.5), its moments by a depthwise
  convolution with zero ``SAME`` padding, variances clamped at 0;
* the photometric reconstruction loss: each alpha frame warped to the
  target through the predicted depth (border padding), 0.85 SSIM + 0.15
  L1, the min over alphas, a masked mean;
* the edge-aware disparity regularity (reflect padding) and its loss;
* the photometric jitter and the horizontal flip with the matching camera
  conjugate;
* the error mask of obtain_depth: pixels whose regularity exceeds mean +
  std (the population std) are dropped.

The jitter takes its five draws as raw uniforms in [0, 1) (``u`` below:
apply, brightness, contrast, saturation, hue) and maps each to its range
as ``jax.random.uniform(minval, maxval)`` does, ``max(lo, u (hi - lo) +
lo)`` in the draw's dtype. On the card the filter's convolution must run
in full f32 (SSIM's E[x^2] - mu^2 cancels): callers hold
``device.py::full_f32``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..geometry.cameras import CameraIntrinsics, unproject_depth
from ..models.manydepth import _warp_features


def _gaussian_kernel(size: int = 5, sigma: float = 1.5, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def _filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D filter of (H, W, C) with zero SAME padding."""
    H, W, C = img.shape
    k = kernel.shape[0]
    x = img.permute(2, 0, 1).reshape(C, 1, H, W)
    out = F.conv2d(x, kernel[None, None], padding=k // 2)
    return out.reshape(C, H, W).permute(1, 2, 0)


def ssim(a: torch.Tensor, b: torch.Tensor, window: int = 5,
         sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM map of two (H, W, C) images in [0, 1]."""
    C1 = 0.01 ** 2
    C2 = 0.03 ** 2
    kern = _gaussian_kernel(window, sigma, a.dtype, a.device)
    mu_a = _filter2d(a, kern)
    mu_b = _filter2d(b, kern)
    # torch.maximum, not clamp: at a tie (a flat window's variance is 0)
    # it splits the gradient as jnp.maximum does.
    zero = a.new_zeros(())
    sa = torch.maximum(_filter2d(a * a, kern) - mu_a ** 2, zero)
    sb = torch.maximum(_filter2d(b * b, kern) - mu_b ** 2, zero)
    sab = _filter2d(a * b, kern) - mu_a * mu_b
    num = (2 * mu_a * mu_b + C1) * (2 * sab + C2)
    den = (mu_a ** 2 + mu_b ** 2 + C1) * (sa + sb + C2)
    return num / den


def photometric_loss(target: torch.Tensor, depth: torch.Tensor,
                     R: torch.Tensor, T: torch.Tensor,
                     alpha_images: torch.Tensor, R_alpha: torch.Tensor,
                     T_alpha: torch.Tensor, intr: CameraIntrinsics,
                     mask: Optional[torch.Tensor] = None,
                     ssim_factor: float = 0.85) -> torch.Tensor:
    """Min-over-alpha 0.85 SSIM + 0.15 L1 reprojection loss. target
    (H, W, 3); depth (H, W); alpha_images (A, H, W, 3) with cameras
    R_alpha (A, 3, 3), T_alpha (A, 3)."""
    world = unproject_depth(depth, R, T, intr)
    warped = torch.stack([
        _warp_features(world, alpha_images[a], R_alpha[a], T_alpha[a], intr,
                       padding="border").reshape(target.shape)
        for a in range(alpha_images.shape[0])])
    l1 = torch.abs(warped - target[None]).mean(dim=-1)
    ssim_maps = torch.stack([((1.0 - ssim(w, target)) / 2.0).mean(dim=-1)
                             for w in warped])
    per_alpha = ssim_factor * ssim_maps + (1.0 - ssim_factor) * l1
    err = per_alpha.amin(dim=0)
    if mask is not None:
        return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return err.mean()


def regularity_tab(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware disparity gradient map (H, W) of disp (H, W) and img
    (H, W, 3), on reflect-padded central differences."""
    dpad = F.pad(disp[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    ipad = F.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1),
                 mode="reflect")[0].permute(1, 2, 0)
    ddx = torch.abs(dpad[1:-1, 2:] - dpad[1:-1, :-2])
    ddy = torch.abs(dpad[2:, 1:-1] - dpad[:-2, 1:-1])
    idx = torch.abs(ipad[1:-1, 2:] - ipad[1:-1, :-2]).mean(dim=-1)
    idy = torch.abs(ipad[2:, 1:-1] - ipad[:-2, 1:-1]).mean(dim=-1)
    return ddx * torch.exp(-idx) + ddy * torch.exp(-idy)


def regularity_loss(disp: torch.Tensor, img: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean edge-aware smoothness of the mean-normalised disparity."""
    norm = disp / (disp.mean() + 1e-7)
    tab = regularity_tab(norm, img)
    if mask is not None:
        return (tab * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return tab.mean()


def _in_range(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` from its raw draw u."""
    lo_t = torch.tensor(lo, dtype=u.dtype, device=u.device)
    hi_t = torch.tensor(hi, dtype=u.dtype, device=u.device)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def color_jitter(u: Sequence[torch.Tensor], images: torch.Tensor,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.1,
                 probability: float = 1.0) -> torch.Tensor:
    """One photometric jitter for a stack of (..., H, W, 3) images. u: five
    raw uniforms (apply, brightness, contrast, saturation, hue)."""
    u_apply, u_b, u_c, u_s, u_h = u
    b = _in_range(u_b, 1 - brightness, 1 + brightness)
    c = _in_range(u_c, 1 - contrast, 1 + contrast)
    s = _in_range(u_s, 1 - saturation, 1 + saturation)
    h = _in_range(u_h, -hue, hue)
    dt = images.dtype
    out = images * b.to(dt)
    mean = out.mean(dim=(-3, -2, -1), keepdim=True)
    out = mean + (out - mean) * c.to(dt)
    gray = out.mean(dim=-1, keepdim=True)
    out = gray + (out - gray) * s.to(dt)
    theta = h * math.pi
    cos_h, sin_h = torch.cos(theta), torch.sin(theta)
    one3 = 1.0 / 3.0
    sqrt3 = 3.0 ** 0.5
    a = cos_h + (1 - cos_h) * one3
    b2 = one3 * (1 - cos_h) - sqrt3 * one3 * sin_h
    c2 = one3 * (1 - cos_h) + sqrt3 * one3 * sin_h
    m = torch.stack([torch.stack([a, b2, c2]), torch.stack([c2, a, b2]),
                     torch.stack([b2, c2, a])]).to(dt)
    out = torch.einsum("...c,dc->...d", out, m)
    out = torch.clamp(out, 0.0, 1.0)
    apply = u_apply < probability
    return torch.where(apply, out, images)


def horizontal_flip(images: torch.Tensor, R: torch.Tensor, T: torch.Tensor):
    """Images mirrored along W; world-to-view rotations and translations
    conjugated with S = diag(-1, 1, 1) so reprojection stays consistent."""
    S = torch.diag(torch.tensor([-1.0, 1.0, 1.0], dtype=R.dtype,
                                device=R.device))
    return torch.flip(images, dims=(-2,)), S @ R @ S, T @ S


def error_mask_from_disparity(disp: torch.Tensor, img: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """The obtain_depth error mask: pixels whose edge-aware regularity
    exceeds mean + std (population std) are dropped."""
    norm = disp / (disp.mean() + 1e-7)
    norm = torch.where(mask, norm, torch.zeros_like(norm))
    tab = regularity_tab(norm, img)
    thr = tab.mean() + tab.std(unbiased=False)
    return tab < thr
