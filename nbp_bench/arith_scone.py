"""The yardstick's arithmetic for the SCONE networks of the MACARONS
next-best-view pose: operations from the published layer shapes, a matrix
product counted as 2 m n k (attention's q k^T and its product with v
included; biases, normalisations, activations and the neighbour search
not counted, as ``torch.utils.flop_counter`` counts them), and the work
that the occupancy-weighted token draw cannot avoid, whatever its design."""

from __future__ import annotations

from typing import Dict

from .arith import PEAK_HBM_BYTES

# The H100's special-function units: 16 results a clock on each of 132
# SMs at 1.98 GHz (the clock of the f32 peak, 67 TFLOP/s).
PEAK_SFU_PER_S = 16 * 132 * 1.98e9


def dense(rows: int, n_in: int, n_out: int) -> float:
    return 2.0 * rows * n_in * n_out


def embedding(rows: int, n_in: int, n_out: int, global_feature: bool
              ) -> float:
    """The MLP embedding whose output, with the raw input (and, halved,
    the global feature) concatenated, is n_out wide."""
    feat = n_out - n_in
    if global_feature:
        feat //= 2
    return dense(rows, n_in, feat) + dense(rows, feat, feat)


def encoder(seqs: int, n: int, d: int) -> float:
    """A pre-LayerNorm encoder on seqs sequences of n tokens of width d:
    q and k d/4 wide, v and the output projection d, attention's two
    products, a feed-forward of width 2d."""
    rows = seqs * n
    qk = d // 4
    return (2 * dense(rows, d, qk) + 2 * dense(rows, d, d)
            + 2.0 * seqs * n * n * qk + 2.0 * seqs * n * n * d
            + dense(rows, d, 2 * d) + dense(rows, 2 * d, d))


def pc_transformer(seqs: int, n: int, d: int, feature: int, n_code: int,
                   n_in: int = 3) -> float:
    return (embedding(seqs * n, n_in, d, False) + n_code * encoder(seqs, n, d)
            + dense(seqs * n, d, feature // 2))


def scone_occ_flops(n_tokens: int, n_queries: int, m: Dict) -> float:
    """SconeOcc on one cloud of n_tokens surface tokens and n_queries
    queries: the global transformer on min(seq_len, n_tokens) tokens, the
    local ones on each query's k neighbours at each scale, the query
    embedding and the head."""
    d, k = m["pts_embedding_dim"], m["k_for_knn"]
    flops = pc_transformer(1, min(m["seq_len"], n_tokens), d,
                           m["global_feature_dim"], m["n_code"])
    flops += m["n_scale"] * pc_transformer(n_queries, k, d,
                                           m["local_feature_dim"],
                                           m["n_code"])
    x = m["x_embedding_dim"]
    flops += (dense(n_queries, 3, x // 4) + dense(n_queries, x // 4, x // 2)
              + dense(n_queries, x // 2, x))
    head_in = (m["global_feature_dim"] + m["n_scale"] * m["local_feature_dim"]
               + x + m["n_harmonics"])
    return flops + (dense(n_queries, head_in, 512) + dense(n_queries, 512, 256)
                    + dense(n_queries, 256, 1))


def scone_vis_flops(n_seqs: int, n_tokens: int, m: Dict) -> float:
    """SconeVis on n_seqs clouds of n_tokens (x, y, z, occupancy) tokens:
    the embedding with its global feature, the encoders and the MLP that
    takes the view harmonics (the view state at the end)."""
    d, nh = m["pts_embedding_dim"], m["n_harmonics"]
    rows = n_seqs * n_tokens
    return (embedding(rows, 4, d, True) + m["n_code"] * encoder(n_seqs,
                                                                n_tokens, d)
            + dense(rows, d, 3 * nh) + dense(rows, 4 * nh, 2 * nh)
            + dense(rows, 2 * nh, nh))


def draw_bound_s(candidates: int, tokens: int, proxy_points: int) -> float:
    """The least device time of a pose's token draw: each (candidate,
    token, proxy point) takes at least one logarithm (the exponential
    race, the argmin of -log(u) / p, picks the Gumbel-max's token), at
    the special-function units' rate; or, where more, the bytes no
    design avoids: the points (12 B) and occupancies (4 B) read once, and
    each token's index (8 B) written. The random bits, the noise's second
    logarithm, the sums and the compares are not counted, so a design
    that writes no noise is bounded too."""
    logs = float(candidates) * tokens * proxy_points / PEAK_SFU_PER_S
    nbytes = 16.0 * proxy_points + 8.0 * candidates * tokens
    return max(logs, nbytes / PEAK_HBM_BYTES)


def pose_work(cfg: Dict, candidates: int) -> Dict[str, float]:
    """A pose's work at a configuration: SconeOcc's and SconeVis's
    operations and the token draw's least device seconds."""
    t, m = cfg["tokens"], cfg["models"]
    return {"occ_flops": scone_occ_flops(t["surface"], t["proxy_queries"],
                                         m["scone_occ"]),
            "vis_flops": scone_vis_flops(candidates, t["vis"],
                                         m["scone_vis"]),
            "draw_bound_s": draw_bound_s(
                candidates, t["vis"], int(cfg["params"]["n_proxy_points"]))}
