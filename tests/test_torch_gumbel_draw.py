"""The Gumbel-max token draw's kernels (``csrc/gumbel.cu``): G1, the noise
a card generator serves (``kernels.gumbel_noise``, ``TorchDraws.gumbel``
and ``gumbels``), and G2, every candidate's masked argmax
(``kernels.gumbel_argmax``, ``predict_coverage_gain`` on a card).

Imports torch and the port only, so that the card, which has no JAX, can
run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gumbel_draw.py

Here: G1's launch arithmetic against torch.rand's, the eager chain a CPU
generator keeps, the batched log-probabilities against the plain draw, the
launchers' refusals before any build, and the ``nbv`` record's draw
counters. Tests marked ``cuda`` decide inside the test whether a card is
present and skip without one; there G1 must give the eager chain's bits
and leave the generator where ``torch.rand`` does, and G2 the tokens of
``torch.argmax(noise + logits)``.
"""

from types import SimpleNamespace

import pytest
import torch

from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch import kernels
from nextbestpath_tpu_torch.draws import TorchDraws
from nextbestpath_tpu_torch.eval import macarons_nbv as TN
from nextbestpath_tpu_torch.sim import coverage_gain as CG
from nextbestpath_tpu_torch.utils import timing

TINY = torch.finfo(torch.float32).tiny


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _eager(gen, shape, device):
    """The eager chain: rand, clamp, log, neg, log, neg."""
    u = torch.rand(shape, generator=gen, device=device).clamp(min=TINY)
    return -torch.log(-torch.log(u))


def _torch_policy(numel, sms, threads):
    """calc_execution_policy of ATen/native/cuda/DistributionTemplates.h
    for unroll 4 (curand_uniform4), transcribed: (grid, counter offset)."""
    block = 256
    grid = (numel + block - 1) // block
    grid = min(sms * (threads // block), grid)
    return grid, ((numel - 1) // (block * grid * 4) + 1) * 4


@pytest.mark.parametrize("n", [1, 4, 255, 256, 257, 40_960_000,
                               2 ** 31 - 1])
def test_rand_policy_is_torch_rand_launch(n):
    """G1's grid and generator advance are torch.rand's on an H100 (132
    SMs of 2,048 threads)."""
    assert kernels.rand_policy(n, 132, 2048) == _torch_policy(n, 132, 2048)
    if n == 40_960_000:   # a candidate's (2,048, 20,000) noise
        assert kernels.rand_policy(n, 132, 2048) == (1056, 152)


@pytest.mark.parametrize("call", ["gumbel", "gumbels"])
def test_cpu_generator_keeps_the_eager_chain(call):
    """A CPU generator's noise is the eager chain's bits, shape after
    shape, and its stream after the draw is unchanged."""
    shapes = [(4,), (7, 33), (), (0, 5), (64, 31)]
    draws = TorchDraws(1234, torch.device("cpu"))
    ref = torch.Generator().manual_seed(1234)
    if call == "gumbel":
        got = [draws.gumbel("dir", s) for s in shapes]
    else:
        got = draws.gumbels("gain", shapes)
    for g, s in zip(got, shapes):
        want = _eager(ref, s, "cpu")
        assert g.dtype == torch.float32 and g.shape == want.shape
        assert torch.equal(g, want)
    assert torch.equal(torch.rand(9, generator=draws.gen),
                       torch.rand(9, generator=ref))


def _field(C=6, P=301, seed=0):
    """Occupancies (P, 1), frustum masks (C, P) with an empty candidate
    and a full one, and noise (C of (n, P))."""
    g = torch.Generator().manual_seed(seed)
    occ = torch.rand((P, 1), generator=g)
    masks = torch.rand((C, P), generator=g) < 0.3
    masks[1] = False
    masks[2] = True
    noise = [_eager(g, (40, P), "cpu") for _ in range(C)]
    return occ, masks, noise


@pytest.mark.parametrize("use_occ", [True, False])
def test_candidate_logits_draw_the_plain_tokens(use_occ):
    """argmax(noise + the batched log-probabilities) is the plain draw,
    candidate by candidate: a masked-out candidate draws uniformly, and
    the low-occupancy points of the others are never drawn."""
    occ, masks, noise = _field()
    logits = CG.candidate_logits(occ, masks, 0.1, use_occ)
    assert logits.shape == masks.shape
    for c in range(masks.shape[0]):
        want = CG.sample_proxy_points(noise[c], occ, masks[c], 0.1, use_occ)
        got = torch.argmax(noise[c] + logits[c], dim=-1)
        assert torch.equal(got, want)
        if c != 1:
            assert bool(((occ[got, 0] > 0.1) & masks[c, got]).all())
    assert torch.equal(logits[1], torch.full_like(logits[1],
                                                  logits[1, 0].item()))


def _fake_card_generator():
    return SimpleNamespace(device=torch.device("cuda", 0))


@pytest.fixture
def no_build(monkeypatch):
    """A launcher that got past its checks would build: fail instead."""
    def build():
        raise AssertionError("the launcher built before refusing")
    monkeypatch.setattr(kernels, "build", build)


@pytest.mark.parametrize("case", ["cpu_generator", "oversized", "negative",
                                  "capture"])
def test_gumbel_noise_refuses_before_building(case, no_build, monkeypatch):
    gen = _fake_card_generator()
    shapes = [(2048, 20000)]
    err, match = ValueError, "shapes of 0 to"
    if case == "cpu_generator":
        gen, match = torch.Generator(), "CUDA generator"
    elif case == "oversized":
        shapes = [(4,), (2 ** 15, 2 ** 14 + 1)]
    elif case == "negative":
        shapes = [(3, -1)]
    else:
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        err, match = RuntimeError, "stream capture"
    with pytest.raises(err, match=match):
        kernels.gumbel_noise(gen, shapes)


@pytest.mark.parametrize("case", ["cpu", "f64_noise", "f64_logits",
                                  "strided_noise", "strided_logits",
                                  "other_p", "other_rows", "count",
                                  "oversized_p"])
def test_gumbel_argmax_refuses_before_building(case, no_build):
    C, n, P = 3, 5, 8
    noise = [torch.zeros(n, P) for _ in range(C)]
    logits = torch.zeros(C, P)
    match = {"cpu": "CUDA tensor", "f64_noise": "float32",
             "f64_logits": "float32", "strided_noise": "contiguous",
             "strided_logits": "contiguous", "other_p": "expected",
             "other_rows": "expected", "count": "expected",
             "oversized_p": "points"}[case]
    if case == "f64_noise":
        noise[1] = noise[1].double()
    elif case == "f64_logits":
        logits = logits.double()
    elif case == "strided_noise":
        noise[2] = torch.zeros(P, n).t()
    elif case == "strided_logits":
        logits = torch.zeros(P, C).t()
    elif case == "other_p":
        noise[1] = torch.zeros(n, P + 4)
    elif case == "other_rows":
        noise[2] = torch.zeros(n + 1, P)
    elif case == "count":
        noise = noise[:2]
    elif case == "oversized_p":
        P = kernels.ARGMAX_MAX_P + 1
        noise = [torch.zeros(1, P) for _ in range(C)]
        logits = torch.zeros(C, P)
    with pytest.raises(ValueError, match=match):
        kernels.gumbel_argmax(noise, logits)


def test_nbv_record_counts_the_token_draws_on_the_cpu():
    """A learned NBV rollout on the CPU: every pose draws all C candidates'
    tokens (``token_draws``), none through the kernel (``kernel_draws``)."""
    small = TC.default_params(**TN.NBV_SMALL)
    scene = TA.pack_generated_scene(TA.generate_scene("simple", seed=6),
                                    params=small)
    occ, vis = TN.seeded_scone(0, small=True)
    n_poses = 2
    TN.macarons_nbv_rollout(scene, occ, vis, params=small, n_poses=n_poses,
                            seed=3, n_tokens=64, n_proxy_tokens=32,
                            device="cpu")
    rec = timing.records()[-1]
    assert rec.kind == "nbv"
    assert rec.counts["token_draws"] == TN.C_MAX * n_poses
    assert rec.counts.get("kernel_draws", 0) == 0


# On the card.

@pytest.mark.cuda
def test_gumbel_noise_on_card_is_the_eager_chain():
    """G1 from a card generator: every shape the eager chain's bits (one
    launch), the generator left where torch.rand leaves it, and
    TorchDraws's gumbel/gumbels the same."""
    _need_card()
    dev = torch.device("cuda")
    shapes = [(4,), (1, 1), (257,), (3, 1000, 7), (0,), (2048, 2000),
              (1, 4097)]
    gen = torch.Generator(device=dev).manual_seed(2 ** 40 + 17)
    ref = torch.Generator(device=dev)
    ref.set_state(gen.get_state())
    before = kernels.LAUNCHES["gumbel_noise"]
    got = kernels.gumbel_noise(gen, shapes)
    assert kernels.LAUNCHES["gumbel_noise"] == before + 1
    for g, s in zip(got, shapes):
        assert torch.equal(g, _eager(ref, s, dev)), s
    assert torch.equal(torch.rand(1000, generator=gen, device=dev),
                       torch.rand(1000, generator=ref, device=dev))
    draws = TorchDraws(5, dev)
    ref.manual_seed(5)
    for g, s in zip(draws.gumbels("gain", shapes[:4]) + [
            draws.gumbel("dir", (4,))], shapes[:4] + [(4,)]):
        assert torch.equal(g, _eager(ref, s, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [20000, 301, 4])
def test_gumbel_argmax_on_card_is_torch_argmax(P):
    """G2 against torch.argmax(noise + logits) a candidate: the 16-byte
    rows and the scalar ones, ties to the smaller index, a NaN above every
    number, a row of -inf scores, and a masked-out candidate."""
    _need_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    C, n = 5, 300
    noise = [torch.rand((n, P), generator=g, device=dev) for _ in range(C)]
    logits = torch.log(torch.rand((C, P), generator=g, device=dev))
    logits[1] = -27.0
    noise[0][3] = 1.0                 # ties: the first index wins
    noise[0][4, P // 2] = float("nan")
    noise[0][4, P - 1] = float("nan")
    noise[2][5] = -float("inf")
    noise[3] = noise[3].round()       # many ties
    got = kernels.gumbel_argmax(noise, logits)
    assert got.dtype == torch.int64 and got.shape == (C, n)
    for c in range(C):
        want = torch.argmax(noise[c] + logits[c], dim=-1)
        assert torch.equal(got[c], want), c
    assert int(got[0, 4]) == P // 2 and int(got[2, 5]) == 0
