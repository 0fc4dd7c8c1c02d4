"""Integer Bresenham lines, vectorised over many lines.

Port of ``nextbestpath_tpu/planning/bresenham.py``: the same integer
algorithm, pixel for pixel, with a fixed step budget; a planner edge is
tested against the layout image by counting obstacle pixels on its line.
"""

from __future__ import annotations

import torch

MAX_LINE_STEPS = 32  # adjacent lattice nodes are ~10 px apart at 256/80 scale


def bresenham_obstacle_count(x0: torch.Tensor, y0: torch.Tensor,
                             x1: torch.Tensor, y1: torch.Tensor,
                             image: torch.Tensor,
                             max_steps: int = MAX_LINE_STEPS) -> torch.Tensor:
    """(N,) number of pixels with image[x, y] == 1 on each line.

    Coordinates are (N,) integer tensors inside the image; every line must
    fit in max_steps pixels."""
    x0, y0, x1, y1 = (a.to(torch.int64) for a in (x0, y0, x1, y1))
    dx = torch.abs(x1 - x0)
    dy = torch.abs(y1 - y0)
    one = torch.ones_like(x0)
    sx = torch.where(x0 < x1, one, -one)
    sy = torch.where(y0 < y1, one, -one)
    x, y, err = x0, y0, dx - dy
    done = torch.zeros_like(x0, dtype=torch.bool)
    count = torch.zeros_like(x0)
    W = image.shape[1]
    flat = image.reshape(-1)
    for _ in range(max_steps):
        hit = (flat[x * W + y] == 1.0) & ~done
        count = count + hit.to(torch.int64)
        finished = (x == x1) & (y == y1)
        e2 = 2 * err
        step_x = e2 > -dy
        step_y = e2 < dx
        new_err = err - torch.where(step_x, dy, 0) + torch.where(step_y, dx, 0)
        done = done | finished
        x = torch.where(done, x, torch.where(step_x, x + sx, x))
        y = torch.where(done, y, torch.where(step_y, y + sy, y))
        err = torch.where(done, err, new_err)
    return count.to(torch.int32)


# The JAX package's vmapped name: the function above already takes N lines.
bresenham_obstacle_count_v = bresenham_obstacle_count
