"""Voxel-deduplicated surface store with coverage state.

Port of ``nextbestpath_tpu/sim/surface_store.py`` (the fixed-array analog
of the reference's Scene/Cell point store): a point occupies a voxel of
side ``resolution``, at most one point a voxel (the first valid point of a
batch wins, by a stable sort of voxel ids), and each stored point carries
a ``covered`` flag for ``camera_coverage_gain``.

``SurfaceStore`` is immutable as the JAX NamedTuple: ``fill`` and
``camera_coverage_gain`` return a new store. A point dropped for capacity
does not mark its voxel. The distances of ``_min_dists_chunked`` and
``scene_coverage`` are plain f32 matmuls over chunks of 2,048 candidates
(at the trainer's 262,144 slots a chunk's (262,144 x 2,048) matrix is 2
GiB), held to full f32 on the card by ``device.py::full_f32``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..device import full_f32


@dataclasses.dataclass(frozen=True)
class SurfaceStore:
    points: torch.Tensor    # (C, 3)
    covered: torch.Tensor   # (C,) coverage-state feature
    occupied: torch.Tensor  # (V,) voxel occupancy bitmap (flattened grid)
    count: torch.Tensor     # 0-d int32
    x_min: torch.Tensor     # (3,)
    inv_res: torch.Tensor   # 0-d f32, 1 / resolution
    dims: torch.Tensor      # (3,) int32 voxel grid dims

    @staticmethod
    def create(capacity: int, x_min, x_max, resolution: float,
               device=None) -> "SurfaceStore":
        x_min = torch.as_tensor(x_min, dtype=torch.float32, device=device)
        x_max = torch.as_tensor(x_max, dtype=torch.float32,
                                device=x_min.device)
        dev = x_min.device
        dims = torch.ceil((x_max - x_min) / resolution).to(torch.int32) + 1
        n_vox = int(torch.prod(dims.long()))
        return SurfaceStore(
            points=torch.zeros((capacity, 3), dtype=torch.float32,
                               device=dev),
            covered=torch.zeros((capacity,), dtype=torch.float32, device=dev),
            occupied=torch.zeros((n_vox,), dtype=torch.bool, device=dev),
            count=torch.zeros((), dtype=torch.int32, device=dev),
            x_min=x_min,
            inv_res=torch.tensor(1.0 / resolution, dtype=torch.float32,
                                 device=dev),
            dims=dims)

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def voxel_id(self, pts: torch.Tensor) -> torch.Tensor:
        ijk = torch.clamp(((pts - self.x_min) * self.inv_res).to(torch.int32),
                          torch.zeros_like(self.dims), self.dims - 1).long()
        d = self.dims.long()
        return (ijk[:, 0] * d[1] + ijk[:, 1]) * d[2] + ijk[:, 2]

    def fill(self, pts: torch.Tensor, valid: torch.Tensor) -> "SurfaceStore":
        """Insert the points whose voxel is still free (one a voxel)."""
        dev = pts.device
        n = pts.shape[0]
        vid = self.voxel_id(pts)
        n_vox = self.occupied.shape[0]
        free = ~self.occupied[vid]
        # The first VALID point a voxel wins: invalid rows sort last.
        sort_key = torch.where(valid, vid, torch.full_like(vid, n_vox))
        order = torch.sort(sort_key, stable=True).indices
        vs = sort_key[order]
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           vs[1:] != vs[:-1]])
        batch_first = torch.zeros_like(valid)
        batch_first[order] = first
        ok = valid & free & batch_first

        n_new = ok.sum().to(torch.int32)
        comp = torch.sort((~ok).to(torch.uint8), stable=True).indices
        pts_c = pts[comp]
        vid_c = vid[comp]
        ar = torch.arange(n, device=dev)
        ok_c = ar < n_new
        cap = self.capacity
        slots = self.count + ar
        stored = ok_c & (slots < cap)
        # Dropped rows land in a scratch row past the end.
        slots = torch.where(stored, slots, torch.full_like(slots, cap))
        points = torch.cat([self.points, self.points.new_zeros((1, 3))])
        points.index_copy_(0, slots.long(), pts_c.to(torch.float32))
        occupied = torch.cat([self.occupied,
                              self.occupied.new_zeros((1,))])
        occupied[torch.where(stored, vid_c, torch.full_like(vid_c, n_vox))] \
            = True
        return dataclasses.replace(
            self, points=points[:-1], occupied=occupied[:-1],
            count=torch.clamp(self.count + n_new, max=cap).to(torch.int32))

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.points.device) \
            < self.count


def _min_dists_chunked(a: torch.Tensor, b: torch.Tensor,
                       b_valid: torch.Tensor, chunk: int = 2048
                       ) -> torch.Tensor:
    """(A,) distance of each row of a to the nearest valid row of b, the
    matmul expansion centred on a's mean, over chunks of ``chunk`` rows of
    b (the last one may be shorter: the JAX package's padding rows are
    invalid and change no minimum)."""
    center = a.mean(dim=0)
    ac = a - center
    bc = b - center
    a2 = (ac * ac).sum(dim=-1)
    best = torch.full((a.shape[0],), 1e30, dtype=a.dtype, device=a.device)
    with full_f32():
        for s in range(0, b.shape[0], chunk):
            pc = bc[s:s + chunk]
            p2 = (pc * pc).sum(dim=-1)
            # (a2 + p2) - 2 ab in place: two chunk-sized temporaries.
            d2 = a2[:, None] + p2[None, :]
            d2.sub_(torch.matmul(ac, pc.T).mul_(2.0))
            d2.masked_fill_(~b_valid[None, s:s + chunk], 1e30)
            best = torch.minimum(best, d2.amin(dim=-1))
            del d2
    return torch.sqrt(torch.clamp(best, min=0.0))


def _coarse_cell_id(store: SurfaceStore, pts: torch.Tensor,
                    cell_factor: int) -> torch.Tensor:
    """Coarse cell ids (cell side = cell_factor voxels), each < n_vox."""
    cd = (store.dims + cell_factor - 1) // cell_factor
    ijk = ((pts - store.x_min) * store.inv_res).to(torch.int32)
    ijk = torch.clamp(torch.div(ijk, cell_factor, rounding_mode="floor"),
                      torch.zeros_like(cd), cd - 1).long()
    cd = cd.long()
    return (ijk[:, 0] * cd[1] + ijk[:, 1]) * cd[2] + ijk[:, 2]


def camera_coverage_gain(store: SurfaceStore, part_pc: torch.Tensor,
                         part_valid: torch.Tensor, epsilon: float,
                         cell_factor: int = 8
                         ) -> Tuple[torch.Tensor, SurfaceStore]:
    """The number of stored points newly within epsilon of part_pc (f32)
    and the store with their covered flags set. A stored point is scored
    only when its coarse cell holds a valid part_pc point."""
    d = _min_dists_chunked(store.points, part_pc, part_valid)
    n_vox = store.occupied.shape[0]
    part_cells = _coarse_cell_id(store, part_pc, cell_factor)
    cell_hit = torch.zeros((n_vox + 1,), dtype=torch.bool,
                           device=part_pc.device)
    cell_hit[torch.where(part_valid, part_cells,
                         torch.full_like(part_cells, n_vox))] = True
    store_cells = _coarse_cell_id(store, store.points, cell_factor)
    near = (d < epsilon) & store.valid_mask() & cell_hit[:-1][store_cells]
    gain = (near & (store.covered < 0.5)).sum()
    covered = torch.where(near, torch.ones_like(store.covered), store.covered)
    return gain.to(torch.float32), dataclasses.replace(store, covered=covered)


def scene_coverage(gt_points: torch.Tensor, gt_cells: torch.Tensor,
                   rec_points: torch.Tensor, rec_cells: torch.Tensor,
                   rec_valid: torch.Tensor, epsilon: float,
                   gt_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cell-restricted coverage: a GT point is covered iff a valid
    reconstructed point in the SAME cell lies within epsilon. gt_valid
    masks padded GT rows (and keeps them out of the centring mean)."""
    if gt_valid is None:
        center = gt_points.mean(dim=0)
    else:
        w = gt_valid.to(gt_points.dtype)[:, None]
        center = (gt_points * w).sum(dim=0) / torch.clamp(w.sum(), min=1.0)
    g = gt_points - center
    r = rec_points - center
    g2 = (g * g).sum(dim=-1)
    r2 = (r * r).sum(dim=-1)
    best = torch.full((g.shape[0],), 1e30, dtype=g.dtype, device=g.device)
    chunk = 2048
    with full_f32():
        for s in range(0, r.shape[0], chunk):
            rc, rc2 = r[s:s + chunk], r2[s:s + chunk]
            d2 = g2[:, None] + rc2[None, :] - 2.0 * torch.matmul(g, rc.T)
            ok = (gt_cells[:, None] == rec_cells[None, s:s + chunk]) \
                & rec_valid[None, s:s + chunk]
            d2 = torch.where(ok, d2, torch.full_like(d2, 1e30))
            best = torch.minimum(best, d2.amin(dim=-1))
    covered = torch.sqrt(torch.clamp(best, min=0.0)) < epsilon
    if gt_valid is not None:
        return (covered & gt_valid).sum() / torch.clamp(
            gt_valid.sum(), min=1).to(torch.float32)
    return covered.to(torch.float32).mean()
