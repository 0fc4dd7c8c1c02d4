"""The planner kernels' designs (nextbestpath_tpu_torch/csrc/plan.cu), held
to the JAX planner on the CPU.

The CUDA kernels run only on a card, so this file models them in Python
step for step: ``bfs_rows_model`` is nbp_bfs_field's row-mask BFS (the
row/bit layout and axis swap, a lane's RPL rows, the shuffles across lanes
and what they bring at the edges, the vote; the one-block path of lattices
past 128 rows), and ``path_chase_model`` is nbp_extract_path's packed-word
chase (the predecessor words, the chase that checks the words' distances
on the side and walks again by the exact rule where one disagreed, a goal
off the lattice, the direct slot writes). Both must equal
the JAX ``bfs_distance_field`` and ``extract_path`` exactly on the same
numpy inputs, and the port's plain versions beside them. The card holds
the kernels to those plain versions (tests/test_torch_kernels.py,
chip_smoke.py phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.planning import grid_paths as JG
from nextbestpath_tpu_torch.planning import grid_paths as TG

INF = 2 ** 20
DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))
WARP, MAX_RPL = 32, 4
WORD_BITS = 64
PATH_DIST_BITS = 20
PATH_DIST_MASK = (1 << PATH_DIST_BITS) - 1
RAW_GOAL = -2

# Kinds of entry into row r, bit b: from row r - 1, row r + 1, bit b - 1,
# bit b + 1, as (row step, bit step) of the move.
KINDS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def row_layout(L, H):
    """(swap, R, W): the longer axis in the word when it fits in 64 bits,
    else the shorter; swap puts rows along h and bits along l."""
    swap = (L > H) if max(L, H) <= WORD_BITS else (L < H)
    return (swap, H, L) if swap else (swap, L, H)


def _node(swap, H, r, b):
    return b * H + r if swap else r * H + b


def entry_masks(blocked, L, H):
    """ok[q][r]: the bits of row r that may be entered by kind q, the edge
    flag read at the source, DIRS[q ^ 2] in the swapped layout."""
    swap, R, W = row_layout(L, H)
    flat = blocked.reshape(4, -1)
    ok = [[0] * R for _ in range(4)]
    for q, (dr, db) in enumerate(KINDS):
        d = q ^ 2 if swap else q
        for r in range(R):
            sr = r - dr
            if not 0 <= sr < R:
                continue
            for b in range(W):
                sb = b - db
                if 0 <= sb < W and not flat[d, _node(swap, H, sr, sb)]:
                    ok[q][r] |= 1 << b
    return ok


def bfs_rows_model(blocked, start, L, H, skip=False):
    """nbp_bfs_field, level by level as the kernel runs it."""
    dist = np.full(L * H, INF, np.int32)
    s0, s1 = start
    if skip or not (0 <= s0 < L and 0 <= s1 < H):
        return dist.reshape(L, H)
    swap, R, W = row_layout(L, H)
    ok = entry_masks(blocked, L, H)
    s_row, s_bit = (s1, s0) if swap else (s0, s1)
    dist[_node(swap, H, s_row, s_bit)] = 0
    if R <= WARP * MAX_RPL:
        rpl = 1 if R <= WARP else (2 if R <= 2 * WARP else 4)
        rows = WARP * rpl
        ok = [m + [0] * (rows - R) for m in ok]
        word = (1 << (32 if W <= 32 else WORD_BITS)) - 1
    else:
        rpl, rows, word = None, R, (1 << 32) - 1
        assert W <= 32
    F = [0] * rows
    V = [0] * rows
    F[s_row] = V[s_row] = 1 << s_bit
    level = 1
    while True:
        # The vote: every second level on the one-warp path, every level
        # (the barrier) on the block path.
        if level > 1 and (rpl is None or level % 2 == 1) and not any(F):
            break
        N = []
        for r in range(rows):
            if rpl is None:
                # The block path: neighbours from the shared frontier, 0
                # past the ends.
                prev = F[r - 1] if r > 0 else 0
                nxt = F[r + 1] if r + 1 < rows else 0
            else:
                lane, k = divmod(r, rpl)
                # __shfl_up/down_sync: lane 0 and lane 31 get their own.
                up = F[(lane - 1) * rpl + rpl - 1] if lane > 0 else F[rpl - 1]
                down = (F[(lane + 1) * rpl] if lane < WARP - 1
                        else F[(WARP - 1) * rpl])
                prev = up if k == 0 else F[r - 1]
                nxt = down if k == rpl - 1 else F[r + 1]
            n = ((prev & ok[0][r]) | (nxt & ok[1][r])
                 | (((F[r] << 1) & word) & ok[2][r])
                 | ((F[r] >> 1) & ok[3][r])) & ~V[r]
            N.append(n)
        for r, n in enumerate(N):
            V[r] |= n
            b = 0
            while n >> b:
                if (n >> b) & 1:
                    dist[_node(swap, H, r, b)] = level
                b += 1
        F = N
        level += 1
    return dist.reshape(L, H)


def _gather_index(i, n):
    i = i + n if i < 0 else i
    return min(max(i, 0), n - 1)


def path_chase_model(dist, blocked, goal, L, H, max_len, skip=False):
    """nbp_extract_path: the words, then one thread's chase."""
    if skip:
        return np.full((max_len, 2), -1, np.int32), 0, False
    d_flat = dist.reshape(-1).astype(np.int64)
    flat = blocked.reshape(4, -1)

    def pred_exact(i, j, d):
        for k, (dl, dh) in enumerate(DIRS):
            pi, pj = i - dl, j - dh
            if 0 <= pi < L and 0 <= pj < H:
                p = pi * H + pj
                if not flat[k, p] and d_flat[p] == d - 1:
                    return p
        return -1

    words = []
    for c in range(L * H):
        dc = int(d_flat[c])
        w = 0
        if 1 <= dc < INF:
            p = pred_exact(c // H, c % H, dc)
            w = ((c if p < 0 else p) << PATH_DIST_BITS) | dc
        assert w < 2 ** 32
        words.append(w)
    gl, gh = int(goal[0]), int(goal[1])
    goal_dist = int(d_flat[_gather_index(gl, L) * H + _gather_index(gh, H)])
    reachable = goal_dist < INF
    length = min(goal_dist, max_len)
    slot = [None] * max_len
    d = goal_dist if reachable else 0
    c = gl * H + gh if (0 <= gl < L and 0 <= gh < H) else -1
    while c < 0 and d >= 1:
        if d <= max_len:
            slot[d - 1] = RAW_GOAL
        c = pred_exact(gl, gh, d)
        d -= 1
    # The chase: one load a step, the words' distances checked on the side;
    # on a mismatch the walk is taken again by the exact rule.
    c0, d0 = c, d
    w = words[c] if c >= 0 else 0
    bad = 0
    while d >= 1:
        if d <= max_len:
            slot[d - 1] = c
        bad |= (w & PATH_DIST_MASK) ^ d
        c = w >> PATH_DIST_BITS
        w = words[c]
        d -= 1
    if bad:
        c = c0
        for d in range(d0, 0, -1):
            if d <= max_len:
                slot[d - 1] = c
            p = pred_exact(c // H, c % H, d)
            c = c if p < 0 else p
    written = length if reachable else 0
    path = np.full((max_len, 2), -1, np.int32)
    for j in range(max(written, 0)):
        s = slot[j]
        path[j] = (gl, gh) if s == RAW_GOAL else divmod(s, H)
    return path, length, reachable


def _serpentine(L, H):
    blocked = np.zeros((4, L, H), bool)
    for j in range(H - 1):
        open_row = (L - 1) if j % 2 == 0 else 0
        for i in range(L):
            if i != open_row:
                blocked[2, i, j] = True
                blocked[3, i, j + 1] = True
    return blocked


def _random(L, H, p=0.3, seed=0):
    return np.random.default_rng(seed).random((4, L, H)) < p


@pytest.fixture(scope="module")
def gt_tables():
    """The GT edge tables of the procgen ``hard`` and ``insane`` scenes
    (seed 8: 40x40 and 58x58 lattices) and their start nodes, as the
    port's scene tables build them."""
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.ops.raytrace import tris_to_soa
    from nextbestpath_tpu_torch.sim.tables import build_scene_tables

    out = {}
    for difficulty in ("hard", "insane"):
        a = pack_generated_scene(generate_scene(difficulty, seed=8))
        t = build_scene_tables(tris_to_soa(torch.from_numpy(a.tris)),
                               torch.tensor([a.n_tris], dtype=torch.int32),
                               torch.from_numpy(a.pose_origin), a.pose_l,
                               a.pose_h)
        out[difficulty] = (t.gt_edge_blocked.numpy(),
                           (int(a.start_cam_idx[0]), int(a.start_cam_idx[2])))
    return out


def _case(name, gt_tables):
    """(blocked (4, L, H) numpy, starts) of a named lattice."""
    if name in ("hard", "insane"):
        blocked, start = gt_tables[name]
        return blocked, [start]
    kind, shape = name.split(" ")
    L, H = map(int, shape.split("x"))
    blocked = {"open": lambda: np.zeros((4, L, H), bool),
               "random": lambda: _random(L, H, 0.3, seed=L * 100 + H),
               "maze": lambda: _serpentine(L, H)}[kind]()
    return blocked, [(0, 0), (L // 2, H // 3), (L - 1, H - 1)]


# Shapes of the one-warp path (1, 2 and 4 rows a lane, bits along h or
# along l) and of the block path (more than 128 rows, both ways).
CASES = ["random 1x64", "open 64x1", "random 3x41", "maze 41x3",
         "random 17x17", "random 64x64", "maze 58x58", "random 100x40",
         "random 200x3", "maze 3x200", "hard", "insane"]


@pytest.mark.parametrize("name", CASES)
def test_models_match_jax_planner(name, gt_tables):
    """The row-mask BFS and the packed-word chase against the JAX planner
    and the port's plain versions, exactly: the field from each start, and
    the path to the farthest reachable node, a near node and the start, at
    max_len 8 on the small lattices and 96 on the large ones (the far goal
    past it on the 58x58 maze and ``insane``)."""
    blocked, starts = _case(name, gt_tables)
    L, H = blocked.shape[1:]
    jb, tb = jnp.asarray(blocked), torch.from_numpy(blocked)
    for start in starts:
        got = bfs_rows_model(blocked, start, L, H)
        want = np.asarray(JG.bfs_distance_field(jb, jnp.asarray(start), L, H))
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {start}")
        plain = TG.bfs_distance_field_plain(tb, torch.tensor(start), L, H)
        np.testing.assert_array_equal(plain.numpy(), want)
        reach = want < INF
        far = np.unravel_index(np.argmax(np.where(reach, want, -1)), (L, H))
        goals = [tuple(map(int, far)), (min(2, L - 1), min(1, H - 1)), start]
        max_len = 8 if L * H < 400 else 96
        for goal in goals:
            pj, lj, rj = JG.extract_path(jnp.asarray(want), jb,
                                         jnp.asarray(goal), L, H,
                                         max_len=max_len)
            pm, lm, rm = path_chase_model(want, blocked, goal, L, H, max_len)
            np.testing.assert_array_equal(pm, np.asarray(pj),
                                          err_msg=f"{name} {goal}")
            assert (lm, rm) == (int(lj), bool(rj))
        if name in ("maze 58x58", "insane"):
            assert int(want[reach].max()) > 96  # the far goal is past max_len


@pytest.mark.parametrize("start", [(-1, 0), (0, -1), (7, 2), (3, 9),
                                   (-5, -5)])
def test_bfs_model_start_off_lattice(start):
    """A start off the lattice: every node INF, in the model, the JAX
    field and the plain version."""
    L, H = 7, 9
    blocked = _random(L, H, 0.2, seed=1)
    got = bfs_rows_model(blocked, start, L, H)
    want = np.asarray(JG.bfs_distance_field(jnp.asarray(blocked),
                                            jnp.asarray(start), L, H))
    assert (got == INF).all() and (want == INF).all()
    plain = TG.bfs_distance_field_plain(torch.from_numpy(blocked),
                                        torch.tensor(start), L, H)
    assert (plain.numpy() == INF).all()


@pytest.mark.parametrize("goal", [(-1, 0), (0, -1), (7, 4), (3, 9), (-3, -3),
                                  (-20, 4), (12, -1), (6, 8), (0, 0)])
@pytest.mark.parametrize("max_len", [3, 32])
def test_path_model_goals_off_lattice(goal, max_len):
    """Goals off the lattice: the distance read where the JAX gather reads
    it, the walk begun at the goal itself, which it leaves only for a
    predecessor on the lattice; the model, the JAX walk and the plain
    version agree."""
    L, H = 7, 9
    blocked = _random(L, H, 0.15, seed=2)
    dist = np.array(JG.bfs_distance_field(jnp.asarray(blocked),
                                          jnp.asarray((3, 4)), L, H))
    pj, lj, rj = JG.extract_path(jnp.asarray(dist), jnp.asarray(blocked),
                                 jnp.asarray(goal), L, H, max_len=max_len)
    pm, lm, rm = path_chase_model(dist, blocked, goal, L, H, max_len)
    np.testing.assert_array_equal(pm, np.asarray(pj))
    assert (lm, rm) == (int(lj), bool(rj))
    pt, lt, rt = TG.extract_path_plain(torch.from_numpy(dist),
                                       torch.from_numpy(blocked),
                                       torch.tensor(goal), L, H, max_len)
    np.testing.assert_array_equal(pt.numpy(), pm)
    assert (int(lt), bool(rt)) == (lm, rm)


@pytest.mark.parametrize("seed", range(6))
def test_path_model_inconsistent_field(seed):
    """A field that is no BFS field of the edges (random distances, some
    INF, some negative): the chase's words disagree with its counter and
    it takes the exact rule; it equals the plain version for every goal."""
    L, H = 6, 7
    rng = np.random.default_rng(seed)
    blocked = rng.random((4, L, H)) < 0.25
    dist = rng.integers(-2, 14, size=(L, H)).astype(np.int32)
    dist[rng.random((L, H)) < 0.1] = INF
    dist[0, 0] = 2 ** 21 + 5
    td, tb = torch.from_numpy(dist), torch.from_numpy(blocked)
    for goal in [(L - 1, H - 1), (2, 3), (0, 0), (-1, 2), (L, 0)]:
        for max_len in (4, 16):
            pm, lm, rm = path_chase_model(dist, blocked, goal, L, H, max_len)
            pt, lt, rt = TG.extract_path_plain(td, tb, torch.tensor(goal), L,
                                               H, max_len)
            np.testing.assert_array_equal(pm, pt.numpy(),
                                          err_msg=f"{goal} {max_len}")
            assert (lm, rm) == (int(lt), bool(rt))


def test_plain_versions_skip():
    """The skip flag: the field all INF, the path all -1 of length 0 and
    unreachable; unset, the outputs of no flag; on the scene axis each
    scene takes its own flag."""
    L, H = 9, 11
    blocked = torch.from_numpy(_random(L, H, 0.2, seed=3))
    start, goal = torch.tensor([1, 2]), torch.tensor([8, 10])
    yes, no = torch.tensor(True), torch.tensor(False)
    field = TG.bfs_distance_field(blocked, start, L, H)
    assert (TG.bfs_distance_field(blocked, start, L, H, yes) == INF).all()
    assert torch.equal(TG.bfs_distance_field(blocked, start, L, H, no), field)
    path = TG.extract_path(field, blocked, goal, L, H, max_len=12)
    assert int(path[1]) > 0 and bool(path[2])
    p, n, r = TG.extract_path(field, blocked, goal, L, H, max_len=12,
                              skip=yes)
    assert p.shape == (12, 2) and p.dtype == torch.int32 and (p == -1).all()
    assert n.dtype == torch.int32 and int(n) == 0 and not bool(r)
    for got, want in zip(TG.extract_path(field, blocked, goal, L, H,
                                         max_len=12, skip=no), path):
        assert torch.equal(got, want)
    B = 4
    bs = torch.stack([blocked, torch.from_numpy(_serpentine(L, H)),
                      blocked, torch.zeros_like(blocked)])
    starts = torch.tensor([[1, 2], [0, 0], [4, 4], [8, 0]])
    goals = torch.tensor([[8, 10], [8, 10], [0, 0], [0, 10]])
    skip = torch.tensor([False, True, False, True])
    fields = TG.bfs_distance_field_scenes(bs, starts, L, H, skip)
    paths = TG.extract_path_scenes(fields, bs, goals, L, H, 12, skip)
    for b in range(B):
        want_f = TG.bfs_distance_field(bs[b], starts[b], L, H, skip[b])
        assert torch.equal(fields[b], want_f)
        want_p = TG.extract_path(want_f, bs[b], goals[b], L, H, 12, skip[b])
        for got, want in zip(paths, want_p):
            assert torch.equal(got[b], want)
        if not skip[b]:
            assert bool(paths[2][b])


def test_scan_rollout_skips_done_attempts_and_matches_jax(monkeypatch):
    """The scan rollout on the CPU with the skip flags wired in: every
    attempt after the first of a plan gets its predecessors' "done" flag,
    the attempts that got it set skip their search, and the rollout is
    still the JAX scan's (trajectory, points and coverage, as
    tests/test_torch_scan_rollout.py holds it)."""
    from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
    from nextbestpath_tpu.config import default_params
    from nextbestpath_tpu.eval.scan_rollout import ScanRollout as JaxScan
    from nextbestpath_tpu_torch import config as TC
    from nextbestpath_tpu_torch.eval import scan_rollout as TS
    from test_torch_rollout import SMALL, JaxDraws, _flax_model
    from test_torch_scan_rollout import (_same_rollout, _torch_assets,
                                         _torch_model)

    model, variables = _flax_model()
    params = default_params(**SMALL)
    assets = pack_generated_scene(generate_scene("normal", seed=8),
                                  params=params)
    want = JaxScan(assets, model, variables, params=params).run(n_poses=8,
                                                                seed=8)
    flags = []
    field = TS.bfs_distance_field

    def spy(blocked, start, L, H, skip=None):
        flags.append(None if skip is None else bool(skip))
        return field(blocked, start, L, H, skip)

    roll = TS.ScanRollout(_torch_assets("normal", 8), _torch_model(variables),
                          params=TC.default_params(**SMALL),
                          draws=JaxDraws(8), device="cpu")
    monkeypatch.setattr(TS, "bfs_distance_field", spy)
    got = roll.run(n_poses=8)
    _same_rollout(got, want)
    retries = roll.max_plan_retries
    assert len(flags) == retries * sum(roll.regen_poses)
    plans = [flags[i:i + retries] for i in range(0, len(flags), retries)]
    assert all(p[0] is False for p in plans)
    # Once set, a plan's flag stays set; most plans are done at once.
    assert all(p == sorted(p) for p in plans)
    assert sum(map(sum, plans)) >= len(plans)
