"""SCONE's occupancy and visibility networks (Guedon et al., NeurIPS 2022,
arXiv:2208.10449) and the visibility gain of a candidate camera that
MACARONS's greedy next-best-view step takes from them (Guedon et al.,
2023, arXiv:2303.03315), as plain functions of a state dict.

* ``Scone.occ``: a global point transformer on a random downsample of at
  most ``seq_len`` surface tokens (an MLP embedding with the raw input
  concatenated, pre-LayerNorm encoders of 4 heads, q/k width d/4,
  feed-forward 2d, LayerNorm and Dense, then concat(max-pool,
  mean-pool)); ``n_scale`` local transformers on the k nearest neighbours
  of each query in progressively downsampled clouds, in offset
  coordinates; a 3-layer GELU embedding of the query; its 64 view
  harmonics; all four concatenated into a 3-layer GELU head.
* ``Scone.vis``: tokens (x, y, z, occupancy) to 64 spherical-harmonic
  coefficients a token: an embedding with a global max feature, encoders,
  LayerNorm, and an MLP that takes the view harmonics beside the
  features.
* ``harmonics``: the real spherical harmonics of degree below 8 (64),
  from the closed form of the associated Legendre functions;
  ``view_harmonics``: a view state's projection onto them.
* ``draw_logits``, ``draw_gaps``: a candidate's occupancy-weighted token
  draw, the argmax of Gumbel noise plus the log-probabilities of the
  proxy points inside its frustum (``jax.random.categorical``'s), and
  how far a given token scores below the best of its row.
* ``gain_terms``: a candidate's gain, the mean over its tokens of the
  sigmoid of the coefficients evaluated toward its camera, times the
  occupancy summed over the proxy points inside its range-limited frustum.

Departures from the published description, kept because the port keeps
them (the flax code the JAX package was written in):

* a mask fills attention scores with -1e3 BEFORE the 1/sqrt(d) scaling
  (no path here passes a mask);
* LayerNorm has epsilon 1e-6 and takes the variance as E[x^2] - E[x]^2
  (clamped at 0);
* GELU is the tanh approximation;
* the attention's output projection is applied only with more than one
  head;
* the occupancy head ends in a GELU, not a sigmoid;
* the embedding's widths are what is left of the output width after the
  concatenated input and, halved, the global feature.

Numerics: f32 with TF32 off for the networks (``unet.full_f32``); the
neighbour search compares exact distances in f64, ties to the lower
index; harmonics and visibility in f64, from the angles toward a camera
as the f32 formula gives them. ``tf32=True`` is the control,
one precision below the configuration's f32: every matrix product's
operands rounded to TF32's 10-bit mantissa (to nearest, ties away from
zero, as the card's conversion rounds), emulated on the bits so that it
runs alike on the CPU and the card; its token draw (``draw_tf32``) adds
the noise and the logits so rounded.

Tensors are named as the port's ``state_dict`` names them (a format, read
here as such): ``PCTransformer_<i>.Embedding_0.Dense_0``,
``.Encoder_<j>.MultiHeadSelfAttention_0.Dense_<0..3>``, ``.LayerNorm_0``,
``.FeedForward_0.Dense_1`` (inner) and ``.Dense_0`` (outer), ...
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
N_HEADS = 4
# Where a neighbour's squared distance lies this close (relative to the
# squared norms it is computed from) to the k-th's, the program's f32
# search may take either: both neighbour sets are sound.
KNN_BAND = 2.0 ** -19
# At most this many other neighbour sets a query and scale.
MAX_SETS = 8
# A proxy point this close to a face of a frustum, relative to the
# coordinates its f32 projection is computed from, may lie on either side
# of it in the program's rounding.
FOV_BAND = 2.0 ** -20


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) with its mantissa rounded to TF32's 10 bits, to nearest,
    ties away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class Scone:
    """The two networks over a state dict each (``occ_sd``, ``vis_sd``;
    either may be None)."""

    def __init__(self, occ_sd: Optional[Dict[str, torch.Tensor]] = None,
                 vis_sd: Optional[Dict[str, torch.Tensor]] = None,
                 tf32: bool = False, k: int = 16, seq_len: int = 2048):
        self.occ_sd, self.vis_sd = occ_sd, vis_sd
        self.tf32, self.k, self.seq_len = tf32, k, seq_len

    # -- products ------------------------------------------------------
    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def _dense(self, sd, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
        if self.tf32:
            x, w = tf32_round(x), tf32_round(w)
        return F.linear(x, w, b)

    # -- blocks --------------------------------------------------------
    def _layer_norm(self, sd, name: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        return ((x - mean) * (torch.rsqrt(var + LN_EPS) * sd[f"{name}.weight"])
                + sd[f"{name}.bias"])

    def _embedding(self, sd, name: str, x: torch.Tensor,
                   global_feature: bool) -> torch.Tensor:
        res = self._dense(sd, f"{name}.Dense_1",
                          gelu(self._dense(sd, f"{name}.Dense_0", x)))
        if global_feature:
            g = res.amax(dim=-2, keepdim=True)
            res = torch.cat([res, g.expand(res.shape)], dim=-1)
        return torch.cat([res, x], dim=-1)

    def _attention(self, sd, name: str, x: torch.Tensor) -> torch.Tensor:
        B, N, d = x.shape
        q = self._dense(sd, f"{name}.Dense_0", x)
        k = self._dense(sd, f"{name}.Dense_1", x)
        v = self._dense(sd, f"{name}.Dense_2", x)
        dq = q.shape[-1] // N_HEADS

        def heads(t):
            return t.reshape(B, N, N_HEADS, -1).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        scores = self._mm(q, k.transpose(-1, -2)) / math.sqrt(dq)
        out = self._mm(torch.softmax(scores, dim=-1), v)
        out = out.transpose(1, 2).reshape(B, N, d)
        return self._dense(sd, f"{name}.Dense_3", out)

    def _encoder(self, sd, name: str, x: torch.Tensor) -> torch.Tensor:
        res = x + self._attention(
            sd, f"{name}.MultiHeadSelfAttention_0",
            self._layer_norm(sd, f"{name}.LayerNorm_0", x))
        h = self._layer_norm(sd, f"{name}.LayerNorm_1", res)
        h = gelu(self._dense(sd, f"{name}.FeedForward_0.Dense_1", h))
        return res + self._dense(sd, f"{name}.FeedForward_0.Dense_0", h)

    def _encoders(self, sd, name: str, x: torch.Tensor) -> torch.Tensor:
        """Every ``<name>.Encoder_<j>`` of the state dict in turn (name ""
        for the top level)."""
        pre = f"{name}." if name else ""
        j = 0
        while f"{pre}Encoder_{j}.LayerNorm_0.weight" in sd:
            x = self._encoder(sd, f"{pre}Encoder_{j}", x)
            j += 1
        return x

    def _pc_transformer(self, name: str, pc: torch.Tensor) -> torch.Tensor:
        """pc (B, N, 3) -> (B, feature) = concat(max, mean) over tokens."""
        sd = self.occ_sd
        x = self._encoders(sd, name, self._embedding(
            sd, f"{name}.Embedding_0", pc, global_feature=False))
        feats = self._dense(sd, f"{name}.Dense_0",
                            self._layer_norm(sd, f"{name}.LayerNorm_0", x))
        return torch.cat([feats.amax(dim=1), feats.mean(dim=1)], dim=-1)

    # -- SconeOcc ------------------------------------------------------
    def n_scale(self) -> int:
        s = 0
        while f"PCTransformer_{s + 1}.Dense_0.weight" in self.occ_sd:
            s += 1
        return s

    def ds_factor(self, n: int) -> int:
        """The local scales' downsampling factor for a cloud of n tokens
        (an integer, at least 2)."""
        ns = self.n_scale()
        if ns <= 1:
            return 1
        return max(int((n / (self.k * 8)) ** (1.0 / (ns - 1))), 2)

    def occ(self, pc: torch.Tensor, x: torch.Tensor, vh: torch.Tensor,
            perms: Sequence[torch.Tensor], chunk: int = 256) -> torch.Tensor:
        """Occupancy of queries x (M, 3) given surface tokens pc (N, 3),
        view harmonics vh (M, 64) and the downsampling permutations (the
        global one of range(N), then scale s's of the scale's cloud):
        (M,) f32. Where the k-th neighbour of a query ties another point
        within ``KNN_BAND``, the occupancy is ``occ_alternatives``'s
        first (the lower indices')."""
        return self.occ_alternatives(pc, x, vh, perms, chunk)[0]

    def occ_alternatives(self, pc, x, vh, perms, chunk: int = 256
                         ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        """(occupancy (M,), {query: (A,) the occupancies of its other
        sound neighbour sets}) -- the latter for the queries whose
        neighbour set at some scale is not decided by f32 rounding."""
        N = pc.shape[0]
        take = min(self.seq_len, N)
        glob = self._pc_transformer("PCTransformer_0",
                                    pc[perms[0][:take]][None])[0]
        f = self.ds_factor(N)
        down = pc
        locals_: List[torch.Tensor] = []
        alt_sets: Dict[int, List[Tuple[int, torch.Tensor]]] = {}
        ns = self.n_scale()
        for s in range(ns):
            idx, alts = knn(x, down, self.k, chunk)
            feats = self._local(s, down, x, idx, chunk)
            locals_.append(feats)
            for q, sets in alts.items():
                alt_sets.setdefault(q, []).extend(
                    (s, self._local(s, down, x[q:q + 1], a, chunk)[0])
                    for a in sets)
            if s < ns - 1:
                n_down = down.shape[0]
                keep = max(n_down // f, self.k)
                down = down[perms[1 + s][:keep]]
        xf = self._x_embedding(x)
        head_in = torch.cat([glob[None].expand(x.shape[0], -1)]
                            + locals_ + [xf, vh], dim=-1)
        out = self._head(head_in)
        others: Dict[int, torch.Tensor] = {}
        width = locals_[0].shape[1]
        g = glob.shape[0]
        for q, alts in alt_sets.items():
            rows = []
            for s, feat in alts:
                row = head_in[q].clone()
                row[g + s * width:g + (s + 1) * width] = feat
                rows.append(row)
            others[q] = self._head(torch.stack(rows))
        return out, others

    def _local(self, s: int, down, x, idx, chunk: int) -> torch.Tensor:
        outs = []
        for c0 in range(0, x.shape[0], chunk):
            nbrs = down[idx[c0:c0 + chunk]] - x[c0:c0 + chunk, None, :]
            outs.append(self._pc_transformer(f"PCTransformer_{1 + s}", nbrs))
        return torch.cat(outs)

    def _x_embedding(self, x: torch.Tensor) -> torch.Tensor:
        sd = self.occ_sd
        for j in range(3):
            x = gelu(self._dense(sd, f"XEmbedding_0.Dense_{j}", x))
        return x

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        for j in range(3):
            h = gelu(self._dense(self.occ_sd, f"Dense_{j}", h))
        return h[:, 0]

    # -- SconeVis ------------------------------------------------------
    def vis(self, pts4: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
        """Coefficients (B, N, 64) of tokens pts4 (B, N, 4) with their
        view harmonics vh (B, N, 64)."""
        sd = self.vis_sd
        x = self._encoders(sd, "", self._embedding(sd, "Embedding_0", pts4,
                                                   global_feature=True))
        res = gelu(self._dense(sd, "Dense_0",
                               self._layer_norm(sd, "LayerNorm_0", x)))
        res = gelu(self._dense(sd, "Dense_1", torch.cat([res, vh], dim=-1)))
        return self._dense(sd, "Dense_2", res)


def knn(x: torch.Tensor, pts: torch.Tensor, k: int, chunk: int = 256
        ) -> Tuple[torch.Tensor, Dict[int, List[torch.Tensor]]]:
    """The k nearest of pts (N, 3) to each query of x (M, 3) by exact
    squared distance (f64), ties to the lower index: (M, k) int64; and,
    for each query whose k-th neighbour lies within ``KNN_BAND`` of a
    point outside the set, its other sound sets ((1, k) each): those that
    swap the band's points at the boundary."""
    xd, pd = x.double(), pts.double()
    scale = (xd * xd).sum(-1)[:, None] + (pd * pd).sum(-1).max()
    out, alts = [], {}
    for c0 in range(0, x.shape[0], chunk):
        d2 = ((xd[c0:c0 + chunk, None, :] - pd[None]) ** 2).sum(-1)
        order = torch.sort(d2, dim=-1, stable=True)
        out.append(order.indices[:, :k])
        if pts.shape[0] <= k:
            continue
        band = KNN_BAND * scale[c0:c0 + chunk, 0]
        gap = order.values[:, k] - order.values[:, k - 1]
        for r in torch.nonzero(gap <= band).flatten().tolist():
            vals, ids = order.values[r], order.indices[r]
            near = torch.nonzero((vals - vals[k - 1]).abs() <= band[r]
                                 ).flatten()
            lo, hi = int(near.min()), int(near.max()) + 1
            fixed, group = ids[:lo], ids[lo:hi]
            need = k - lo
            # Each choice of ``need`` of the band's points, in
            # lexicographic order: the first, the lower indices', is the
            # search's own.
            combos = itertools.combinations(range(group.shape[0]), need)
            sets = [torch.cat([fixed, group[list(c)]])[None]
                    for c in itertools.islice(combos, 1, 1 + MAX_SETS)]
            if sets:
                alts[c0 + r] = sets
    return torch.cat(out), alts


# -- spherical harmonics ----------------------------------------------------

def _legendre(l: int, m: int, x: torch.Tensor) -> torch.Tensor:
    """The associated Legendre function P_l^m(x), m >= 0, with the
    Condon-Shortley phase, from its closed form
    (-1)^m (1 - x^2)^(m/2) d^m/dx^m P_l(x), P_l(x) = 2^-l sum_j (-1)^j
    C(l, j) C(2l - 2j, l) x^(l - 2j)."""
    poly = torch.zeros_like(x)
    for j in range(l // 2 + 1):
        p = l - 2 * j
        if p < m:
            continue
        c = ((-1) ** j * math.comb(l, j) * math.comb(2 * l - 2 * j, l)
             * math.perm(p, m) / 2.0 ** l)
        poly = poly + c * x ** (p - m)
    return (-1) ** m * torch.clamp(1.0 - x * x, min=0.0) ** (m / 2.0) * poly


def harmonics(theta: torch.Tensor, phi: torch.Tensor,
              n_degrees: int = 8) -> torch.Tensor:
    """Real spherical harmonics Y_l^m, l < n_degrees, m = -l..l, at polar
    angle theta and azimuth phi: (..., n_degrees^2), f64. Y_l^0 =
    N_l P_l(cos theta); Y_l^m = N_l sqrt(2 (l-|m|)!/(l+|m|)!) P_l^|m|(cos
    theta) cos(m phi) for m > 0 and sin(|m| phi) for m < 0, N_l =
    sqrt((2l+1)/(4 pi))."""
    theta, phi = theta.double(), phi.double()
    x = torch.cos(theta)
    out = []
    for l in range(n_degrees):
        n_l = math.sqrt((2 * l + 1) / (4.0 * math.pi))
        for m in range(-l, l + 1):
            a = abs(m)
            leg = _legendre(l, a, x)
            if m == 0:
                out.append(n_l * leg)
                continue
            norm = n_l * math.sqrt(2.0 * math.factorial(l - a)
                                   / math.factorial(l + a))
            trig = torch.cos(m * phi) if m > 0 else torch.sin(a * phi)
            out.append(norm * leg * trig)
    return torch.stack(out, dim=-1)


def view_harmonics(view_states: torch.Tensor, n_elev: int, n_azim: int,
                   n_degrees: int = 8) -> torch.Tensor:
    """The spherical L2 projection of view states (..., n_elev n_azim)
    onto the harmonics, f64 (..., n_degrees^2): the directions at
    elevation -pi/2 + (i + 1) pi / (n_elev + 1) (rows) and azimuth
    j 2 pi / n_azim - pi (columns), each weighted by the sine of its polar
    angle times the two steps."""
    d_polar, d_azim = math.pi / (n_elev + 1), 2.0 * math.pi / n_azim
    elev = torch.tensor([-math.pi / 2 + (i + 1) * d_polar
                         for i in range(n_elev) for _ in range(n_azim)],
                        dtype=torch.float64, device=view_states.device)
    azim = torch.tensor([j * d_azim - math.pi
                         for _ in range(n_elev) for j in range(n_azim)],
                        dtype=torch.float64, device=view_states.device)
    theta = math.pi / 2 - elev
    w = torch.sin(theta) * d_polar * d_azim
    return (view_states.double() * w) @ harmonics(theta, azim, n_degrees)


def spherical(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(polar angle, azimuth) of directions v (..., 3), as SCONE's code
    takes them: elevation asin(y / r), azimuth acos(z / (r cos e)) with
    the sign of x, both clamped; polar angle pi/2 - elevation."""
    r = torch.linalg.norm(v, dim=-1)
    elev = torch.asin(torch.clamp(v[..., 1] / torch.clamp(r, min=1e-12),
                                  -1.0, 1.0))
    cos_a = torch.clamp(v[..., 2] / torch.clamp(r * torch.cos(elev),
                                                 min=1e-12), -1.0, 1.0)
    azim = torch.where(v[..., 0] < 0, -torch.acos(cos_a), torch.acos(cos_a))
    return math.pi / 2.0 - elev, azim


# -- the candidate's gain ---------------------------------------------------

def camera(pose5: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eye (3,), axes (3, 3), rows x, y, z) of a pose (x, y, z,
    elevation, azimuth in degrees), f64: z the view direction (cos e sin
    a, sin e, cos e cos a), x = up x z, y = z x x, up = +y."""
    p = pose5.double()
    e, a = torch.deg2rad(p[3]), torch.deg2rad(p[4])
    z = torch.stack([torch.cos(e) * torch.sin(a), torch.sin(e),
                     torch.cos(e) * torch.cos(a)])
    up = torch.zeros_like(z)
    up[1] = 1.0
    x = torch.linalg.cross(up, z)
    x = x / torch.linalg.norm(x)
    y = torch.linalg.cross(z, x)
    return p[:3], torch.stack([x, y, z / torch.linalg.norm(z)])


def in_frustum(points: torch.Tensor, pose5: torch.Tensor, H: int, W: int,
               fov_deg: float, max_range: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inside, undecided) (P,) of proxy points in a camera's frustum,
    f64: view z > 0, the point's ray inside the frame's NDC extent (pixel
    centres from W/m to W/m - 2(W-1)/(m-1) in x, m = min(H, W), and
    likewise in y), nearer than max_range. ``undecided``: within
    ``FOV_BAND`` times (1 + the largest coordinate of the point and of the
    eye) of a face, in world units, where f32 rounding may put the point
    on either side; ``inside`` is the exact answer there."""
    eye, axes = camera(pose5)
    p = points.double()
    d = p - eye
    xc, yc, zc = d @ axes[0], d @ axes[1], d @ axes[2]
    t = math.tan(math.radians(fov_deg) / 2.0)
    m = min(H, W)

    def face(v, c, sign):
        # Signed distance from the plane v = c t z through the eye.
        return sign * (c * t * zc - v) / math.sqrt(1.0 + (c * t) ** 2)

    slack = torch.stack([
        face(xc, W / m, 1.0), face(xc, W / m - 2.0 * (W - 1) / (m - 1), -1.0),
        face(yc, H / m, 1.0), face(yc, H / m - 2.0 * (H - 1) / (m - 1), -1.0),
        zc, max_range - torch.linalg.norm(d, dim=-1)])
    band = FOV_BAND * (1.0 + eye.abs().max() + p.abs().amax(dim=-1))
    inside = (slack >= 0).all(0) & (slack[4:] > 0).all(0)
    undecided = (slack >= -band).all(0) & ~(slack > band).all(0)
    return inside, undecided


LOG_FLOOR = math.log(1e-12)


def draw_logits(occ: torch.Tensor, inside: torch.Tensor,
                undecided: torch.Tensor, min_occ: float
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The logits of a candidate's occupancy-weighted token draw, f64
    (P,), one entry for each way the frustum's undecided points can make
    it sound, each with the points (P,) that may be the draw's argmax.

    A point may be drawn where it lies in the frustum and its occupancy
    (f32) exceeds ``min_occ`` (compared in f32); its probability is its
    occupancy over theirs summed, and every other point's is floored at
    1e-12, as ``jax.random.categorical`` takes the log of the clamped
    probabilities. With no point allowed, the draw is uniform over all.
    An undecided point (``in_frustum``) may be drawn, but where it could
    only win by being allowed it is not counted as the argmax."""
    occ64 = occ.double()
    heavy = occ.float() > torch.tensor(min_occ, dtype=torch.float32)
    sure = inside & ~undecided & heavy
    maybe = undecided & heavy

    def logits(allowed, total):
        return torch.where(allowed,
                           torch.log(torch.clamp(occ64 / total, min=1e-12)),
                           torch.full_like(occ64, LOG_FLOOR))

    if bool(sure.any()):
        return [(logits(sure | maybe, occ64[sure].sum()), ~maybe)]
    everyone = torch.ones_like(heavy)
    uniform = (torch.full_like(occ64, -math.log(occ.shape[0])), everyone)
    if not bool(maybe.any()):
        return [uniform]
    return [uniform, (logits(maybe, occ64[maybe].sum()), everyone)]


def draw_gaps(noise: torch.Tensor, hyps, picked: Optional[torch.Tensor],
              chunk: int = 256
              ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The Gumbel-max draw of a candidate's tokens from its noise (n, P)
    and ``draw_logits``'s entries, in f64: (the gap of each picked token
    (n,) below the best score of its row, the least over the entries, 0
    where it is the best, or None without ``picked``; the draw's own
    tokens (n,), the first entry's argmax)."""
    gaps, idx = [], []
    for t0 in range(0, noise.shape[0], chunk):
        u = noise[t0:t0 + chunk].double()
        gap = None
        for h, (logit, may_win) in enumerate(hyps):
            s = u + logit[None]
            best, arg = torch.where(may_win[None], s,
                                    torch.full_like(s, -math.inf)).max(1)
            if h == 0:
                idx.append(arg)
            if picked is None:
                break
            g = best - s.gather(1, picked[t0:t0 + chunk, None])[:, 0]
            gap = g if gap is None else torch.minimum(gap, g)
        if gap is not None:
            gaps.append(torch.clamp(gap, min=0.0))
    return (torch.cat(gaps) if gaps else None), torch.cat(idx)


def draw_tf32(noise: torch.Tensor, hyps, chunk: int = 256) -> torch.Tensor:
    """The control's draw: the argmax of the noise plus the first entry's
    logits, both rounded to TF32 and added in f32, (n,)."""
    logit = tf32_round(hyps[0][0].float())
    return torch.cat([(tf32_round(noise[t0:t0 + chunk].float())
                       + logit[None]).argmax(1)
                      for t0 in range(0, noise.shape[0], chunk)])


def gain_terms(net: Scone, proxy: torch.Tensor, occ: torch.Tensor,
               vh: torch.Tensor, idx: torch.Tensor, pose5: torch.Tensor,
               box_min: torch.Tensor, box_max: torch.Tensor, H: int, W: int,
               fov_deg: float, max_range: float) -> Dict[str, object]:
    """One candidate's predicted gain from the tokens the program drew
    (idx (n,) into the proxy points (P, 3), occupancies (P,), view
    harmonics (P, 64)): the mean visibility of the tokens toward the
    camera, times the occupancy summed over the proxy points inside the
    frustum; -1 where no proxy point is inside. Returns ``mean_vis``,
    ``base`` and ``n_base`` (the occupancy and count of the points inside
    and not ``undecided``), ``undecided`` (those points' occupancies) and
    ``gain`` (the exact f64 frustum's)."""
    diag = torch.linalg.norm(box_max - box_min)
    tok = proxy[idx]
    center = (tok.amax(dim=0) + tok.amin(dim=0)) / 2.0
    pts = (tok - center) / diag
    h = net.vis(torch.cat([pts, occ[idx, None]], dim=-1)[None],
                vh[idx][None])[0]
    cam = (pose5[:3].to(pts.dtype) - center) / diag
    # The angles in f32, the configuration's precision: SCONE's asin and
    # acos are ill-conditioned near +-1 (a token nearly level with the
    # camera in x), where f32 and f64 angles part by up to 1e-3 rad.
    theta, phi = spherical(cam[None] - pts)
    z = (harmonics(theta, phi) * h.double()).sum(-1)
    mean_vis = float(torch.sigmoid(z).mean())
    inside, undecided = in_frustum(proxy, pose5, H, W, fov_deg, max_range)
    occ_d = occ.double()
    sure = inside & ~undecided
    return {"mean_vis": mean_vis, "base": float(occ_d[sure].sum()),
            "n_base": int(sure.sum()), "undecided": occ_d[undecided].cpu(),
            "gain": (mean_vis * float(occ_d[inside].sum())
                     if bool(inside.any()) else -1.0)}
