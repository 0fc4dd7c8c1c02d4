"""The yardstick's arithmetic: the chip's peaks, the U-Net's operations
from its published layer shapes, and the bytes and operations that the
sensor kernel (K1) and the coverage kernel (K3) need."""

from __future__ import annotations

from typing import List, Tuple

# NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# K1: a ray's direction in (12 B) and its t, hit count and index out
# (12 B); a frame's triangles once, as the pinhole SoA (10 floats).
K1_BYTES_PER_RAY = 24
K1_BYTES_PER_TRIANGLE = 40
# K3: a (GT point, sample) pair is three differences, three products and
# two sums, and the running minimum: 9 f32 operations. The count assumes
# the brute-force search over every pair that the reference performs.
K3_OPS_PER_PAIR = 9


def unet_convs(img_ch: int = 5, width: int = 64, size: int = 256,
               out1: int = 8, out2: int = 1
               ) -> List[Tuple[int, int, int, int]]:
    """Every convolution of the NBP dual-decoder attention U-Net (the
    paper's network, models/unet.py's layer list) as (c_in, c_out, kernel,
    output side): the encoder's five double 3x3 blocks, each decoder's
    2x up-convolutions, attention gates (three 1x1 convolutions) and
    double blocks, and the two 1x1 heads."""
    w = width
    convs: List[Tuple[int, int, int, int]] = []

    def block(cin, cout, side):
        convs.extend([(cin, cout, 3, side), (cout, cout, 3, side)])

    def gate(cg, cx, f_int, side):
        convs.extend([(cg, f_int, 1, side), (cx, f_int, 1, side),
                      (f_int, 1, 1, side)])

    enc = [(img_ch, w), (w, 2 * w), (2 * w, 4 * w), (4 * w, 8 * w),
           (8 * w, 16 * w)]
    for k, (cin, cout) in enumerate(enc):
        block(cin, cout, size >> k)
    # Decoder 1 (the value map, at size / 4) and decoder 2 (the obstacle
    # map), each from the bottleneck.
    dec1 = [(16 * w, 8 * w), (8 * w, 4 * w)]
    dec2 = [(16 * w, 8 * w), (8 * w, 4 * w), (4 * w, 2 * w), (2 * w, w)]
    for dec, out in ((dec1, out1), (dec2, out2)):
        side = size >> 4
        for cin, cout in dec:
            side *= 2
            convs.append((cin, cout, 3, side))        # up-convolution
            gate(cout, cout, cout // 2, side)         # attention gate
            block(2 * cout, cout, side)               # after the concat
        convs.append((dec[-1][1], out, 1, side))      # head
    return convs


def unet_forward_flops(batch: int = 1, **shape) -> float:
    """Operations of one U-Net forward, 2 a multiply-add, convolutions
    only (as ``torch.utils.flop_counter`` counts them): 182.41 GFLOP for
    one 256x256x5 input at width 64."""
    return float(batch * sum(2 * cin * cout * k * k * side * side
                             for cin, cout, k, side in unet_convs(**shape)))


def k1_bytes(n_frames: int, rays_per_frame: int, n_tris: int) -> float:
    """Bytes that n_frames depth frames of rays_per_frame rays against a
    scene of n_tris triangles must move, however they are computed."""
    return float(n_frames * (K1_BYTES_PER_RAY * rays_per_frame
                             + K1_BYTES_PER_TRIANGLE * n_tris))


def k3_ops(pairs: float) -> float:
    return float(K3_OPS_PER_PAIR * pairs)
