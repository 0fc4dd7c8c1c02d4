"""The comparisons that decide ``correct`` in the next-best-view cell, each
number with its limit from the configuration's ``limits``. At the poses
``drivers/nbv.py`` recorded (drawn from the seed), the plain reference
(``reference/scone.py``) is given the rollout's state and the run's
draws there, and works out the rest itself:

* from the provider's draws: SconeOcc's downsampling permutations, the
  proxy points it queried and each candidate's Gumbel noise;
* from the rollout's state: SconeOcc's surface tokens and queries, the
  proxy field as the gain read it (points, occupancies, view states),
  the candidates' poses, and the tokens SconeVis was given;
* its own: the view harmonics of the view states, each candidate's
  frustum and its token draw, and the two networks.

Numbers:

* ``occ_err``: the largest |program - reference| of the occupancies of a
  pose's queries. Where a query's k-th neighbour ties another point to
  f32 rounding (``reference.scone.KNN_BAND``), each sound neighbour set
  gives a reference, and the query reads the nearest.
* ``draw_err``: over the poses' candidates and tokens, the largest gap of
  the program's token below the best score of its row (Gumbel noise
  plus log-probability, in f64, ``reference.scone.draw_gaps``): 0 where
  the program drew the reference's token, the f32 rounding of a score
  where two tie, about 27 or more for a point outside the draw's allowed
  set, and ``UNMATCHED`` for a token that is no proxy point. The
  program's tokens are read from SconeVis's input (``program_tokens``).
* ``gain_err``: over the poses, the largest of max_c |g - g_ref| /
  max_c |g_ref| over the pose's valid candidates c, the reference's gain
  taken over the program's tokens. A proxy point on a face of a frustum
  to f32 rounding (``FOV_BAND``) may be counted either way: |g - g_ref|
  is the least over the volumes with and without each such point. Gains
  are compared, not the argmax: with seeded weights the best candidate
  can change on rounding.

With ``control``, the same numbers of the control (the reference with
every matrix product's operands rounded to TF32, and its token draw's
two addends) in the program's place.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import torch

from .reference import scone as rs
from .reference.unet import full_f32

Checks = Dict[str, Tuple[float, float]]

# ``draw_err`` of a token that is no proxy point.
UNMATCHED = 1e3
# A token is the proxy point within this distance of it, relative to 1 +
# its largest coordinate (the f32 rounding of its normalised coordinates
# is about 1e-7 of that).
MATCH_TOL = 1e-5


def _occ_errs(prog: torch.Tensor, ref: torch.Tensor,
              alts: Dict[int, torch.Tensor]) -> torch.Tensor:
    err = (prog.double() - ref.double()).abs()
    for q, vals in alts.items():
        err[q] = torch.minimum(err[q],
                               (prog[q].double() - vals.double()).abs().min())
    return err


def program_tokens(pts4: torch.Tensor, proxy: torch.Tensor,
                   own: torch.Tensor, diag: torch.Tensor,
                   chunk: int = 512) -> torch.Tensor:
    """The proxy point of each token SconeVis was given (pts4 (n, 4): its
    coordinates about the tokens' box centre over ``diag``, and its
    occupancy): (n,) int64, -1 where no proxy point lies within
    ``MATCH_TOL``. The centre is the median over the tokens of what the
    reference's own tokens ``own`` give, so the tokens that agree fix
    it."""
    p64 = proxy.double()
    q = pts4[:, :3].double() * diag
    pts = q + (p64[own] - q).median(dim=0).values
    tol = MATCH_TOL * (1.0 + pts.abs().amax(dim=1))
    idx = torch.where((pts - p64[own]).norm(dim=1) <= tol, own,
                      torch.full_like(own, -1))
    rest = torch.nonzero(idx < 0).flatten()
    for r0 in range(0, rest.shape[0], chunk):
        rows = rest[r0:r0 + chunk]
        d, j = torch.cdist(pts[rows], p64).min(dim=1)
        idx[rows] = torch.where(d <= tol[rows], j, idx[rows])
    return idx


def draw_reading(noise, tokens: torch.Tensor, proxy: torch.Tensor,
                 proba: torch.Tensor, pose5: torch.Tensor,
                 box_min: torch.Tensor, box_max: torch.Tensor, geo: Dict,
                 min_occ: float, control: bool) -> Dict:
    """A pose's token draws against the reference's, from each
    candidate's noise (n, P) as the provider served it, the tokens
    SconeVis was given (C, n, 4) and the field as the gain read it:
    ``idx`` (C, n), the program's tokens (the reference's own where none
    matches), ``draw_err`` and ``unmatched`` (the pose's largest gap and
    its tokens that are no proxy point) and, with ``control``,
    ``ctl_draw_err``."""
    diag = torch.linalg.norm(box_max.double() - box_min.double())
    out = {"idx": [], "draw_err": 0.0, "unmatched": 0}
    if control:
        out["ctl_draw_err"] = 0.0
    for c in range(pose5.shape[0]):
        inside, undecided = rs.in_frustum(proxy, pose5[c], **geo)
        hyps = rs.draw_logits(proba, inside, undecided, min_occ)
        _, own = rs.draw_gaps(noise[c], hyps, None)
        prog = program_tokens(tokens[c], proxy, own, diag)
        found = prog >= 0
        gaps, _ = rs.draw_gaps(noise[c], hyps, torch.where(found, prog, own))
        gaps = torch.where(found, gaps, torch.full_like(gaps, UNMATCHED))
        out["draw_err"] = max(out["draw_err"], float(gaps.max()))
        out["unmatched"] += int((~found).sum())
        out["idx"].append(torch.where(found, prog, own))
        if control:
            ctl = rs.draw_tf32(noise[c], hyps)
            out["ctl_draw_err"] = max(out["ctl_draw_err"], float(
                rs.draw_gaps(noise[c], hyps, ctl)[0].max()))
    out["idx"] = torch.stack(out["idx"])
    return out


# At most this many proxy points on a face of one frustum are taken one
# subset at a time; past it, the volume may lie anywhere between the sums
# of their negative and of their positive occupancies.
MAX_UNDECIDED = 12


def _allowed(t: Dict) -> Tuple[torch.Tensor, bool]:
    """The gains a sound program may give a candidate, from the
    reference's terms: the mean visibility times the volume with any
    subset of the points on a face, -1 for the empty one where no other
    point is inside; (values, whether they bound an interval)."""
    u = t["undecided"]
    n = u.shape[0]
    if n > MAX_UNDECIDED:
        ends = torch.stack([u.clamp(max=0).sum(), u.clamp(min=0).sum()])
        vals = t["mean_vis"] * (t["base"] + ends)
        if t["n_base"] == 0:
            vals = torch.cat([vals, torch.tensor([-1.0], dtype=vals.dtype)])
        return vals, True
    bits = (torch.arange(2 ** n)[:, None] >> torch.arange(n)[None]) & 1
    vals = t["mean_vis"] * (t["base"] + bits.to(u.dtype) @ u)
    if t["n_base"] == 0:
        vals[0] = -1.0
    return vals, False


def _err(g: float, t: Dict) -> float:
    vals, interval = _allowed(t)
    err = float((vals - g).abs().min())
    if interval and float(vals[0]) <= g <= float(vals[1]):
        return 0.0
    return err


def _gain_err(prog, terms: List[Dict], valid) -> Tuple[float, int]:
    """(the pose's max_c |g - g_ref| / max_c |g_ref| over the valid
    candidates c, the worst candidate)."""
    ok = [c for c in range(len(terms)) if bool(valid[c])]
    errs = {c: _err(float(prog[c]), terms[c]) for c in ok}
    scale = max(abs(terms[c]["gain"]) for c in ok)
    worst = max(ok, key=lambda c: errs[c])
    return errs[worst] / max(scale, 1e-30), worst


def nbv(data: List[Dict], occ_sd, vis_sd, cfg: Dict, params, geo: Dict,
        control: bool) -> Tuple[Checks, Optional[Dict[str, float]]]:
    lim = cfg["limits"]
    m = cfg["models"]["scone_occ"]
    kw = dict(k=int(m["k_for_knn"]), seq_len=int(m["seq_len"]))
    ref = rs.Scone(occ_sd, vis_sd, **kw)
    ctl = rs.Scone(occ_sd, vis_sd, tf32=True, **kw) if control else None
    views = dict(n_elev=int(params.view_state_n_elev),
                 n_azim=int(params.view_state_n_azim),
                 n_degrees=int(params.harmonic_degree))
    occ_e, gain_e, occ_c, gain_c = [], [], [], []
    with full_f32(), torch.no_grad():
        for d in data:
            vh = rs.view_harmonics(d["view_states"], **views).float()
            vh_q = vh[d["vs_idx"]]
            r_occ, alts = ref.occ_alternatives(d["pc"], d["x"], vh_q,
                                               d["perms"])
            e = _occ_errs(d["occ"], r_occ, alts)
            occ_e.append(float(e.max()))
            if ctl is not None:
                c_occ = ctl.occ(d["pc"], d["x"], vh_q, d["perms"])
                occ_c.append(float(_occ_errs(c_occ, r_occ, alts).max()))
            terms, c_gains = [], []
            for c in range(d["pose5"].shape[0]):
                args = dict(proxy=d["proxy"], occ=d["proba"], vh=vh,
                            idx=d["idx"][c], pose5=d["pose5"][c],
                            box_min=d["box_min"], box_max=d["box_max"], **geo)
                terms.append(rs.gain_terms(ref, **args))
                if ctl is not None:
                    c_gains.append(rs.gain_terms(ctl, **args)["gain"])
            g_err, worst = _gain_err(d["gains"], terms, d["valid"])
            gain_e.append(g_err)
            t = terms[worst]
            print(f"# nbv check: occ_err {occ_e[-1]!r} ({len(alts)} queries "
                  f"with tied neighbours); draw_err {d['draw_err']!r} "
                  f"({d['unmatched']} tokens no proxy point); gain_err "
                  f"{g_err!r} (candidate {worst}: program "
                  f"{float(d['gains'][worst])!r}, reference {t['gain']!r}; "
                  f"{int(sum(d['valid']))} valid; proxy points on a face "
                  f"{sum(x['undecided'].shape[0] for x in terms)})",
                  file=sys.stderr)
            if ctl is not None:
                gain_c.append(_gain_err(c_gains, terms, d["valid"])[0])
    vals = {"occ_err": max(occ_e),
            "draw_err": max(d["draw_err"] for d in data),
            "gain_err": max(gain_e)}
    checks = {k: (v, float(lim[k])) for k, v in vals.items()}
    if ctl is None:
        return checks, None
    return checks, {"occ_err": max(occ_c),
                    "draw_err": max(d["ctl_draw_err"] for d in data),
                    "gain_err": max(gain_c)}
