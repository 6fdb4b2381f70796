"""RNN-B's unrolled window served on ``kernel_q8`` through
``AsyncMultiModelServer``. On the CPU the served logits equal, to the bit,
a plain sum of the tables as int8 codes: one float32 scale a group, each
term ``float(q) · s_k`` added in ascending k, as the int8 bank kernel adds
them. The same banks on int4 tables or on float32 tables read far outside
the benchmark's limit, so the limit tells the int8 arithmetic apart. On the
card one graph replay launches the int8 bank kernel 16 times and the
float32 one never, and the served logits equal the plain int8 sum there
too. Imports no JAX."""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import numpy as np
import pytest
import torch

from repro_torch.launch.request import InferRequest
from repro_torch.launch.serve import AsyncMultiModelServer
from repro_torch.nets.rnn import PegasusRNN
from test_torch_rnn_b import WINDOW, _leaves, _rnn

# bench/configs/rnn-b-q8.json: the widest logit gap over the logits' spread
LIMIT = 0.01
MARGIN = 100
SIZES = [1, 7, 33, 64, 300, 295]
INT8, INT4 = 127, 7


def _codes(lut: torch.Tensor, levels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric codes in [-levels, levels] a group, scale ``max|lut_k| /
    levels``, rounded half to even: (codes as float32, scales ``[K]``)."""
    scale = torch.clamp(lut.abs().amax(dim=(1, 2)), min=1e-8) / levels
    return torch.clamp(torch.round(lut / scale[:, None, None]), -levels, levels), scale


def _plain_bank(p, x: torch.Tensor, levels: int | None) -> torch.Tensor:
    """The leaves' table rows summed in ascending k, each term ``q · s_k``
    with the table as codes of ``levels`` (None: the float32 table), then
    the bias."""
    leaf = _leaves(p, x)
    codes, scale = (p.lut, None) if levels is None else _codes(p.lut, levels)
    y = torch.zeros((x.shape[0], p.lut.shape[2]), device=x.device)
    for j in range(p.lut.shape[0]):
        row = codes[j, leaf[:, j]]
        y = y + (row if scale is None else row * scale[j])
    return y if p.bias is None else y + p.bias


def _reference(m, seq, levels: int | None) -> torch.Tensor:
    """h_0 = X_0(x_0), h_t = X_t(x_t) + H_t(h_{t-1}), logits = O(h_7), on
    the device of ``m``'s tables."""
    x = torch.as_tensor(seq, device=m.out_bank.lut.device).to(torch.float32)
    h = _plain_bank(m.x_banks[0], x[:, 0], levels)
    for t in range(1, WINDOW):
        h = _plain_bank(m.x_banks[t], x[:, t], levels) + _plain_bank(m.h_banks[t - 1], h,
                                                                       levels)
    return _plain_bank(m.out_bank, h, levels)


def _on(m: PegasusRNN, device) -> PegasusRNN:
    return PegasusRNN(x_banks=[b.to(device) for b in m.x_banks],
                      h_banks=[b.to(device) for b in m.h_banks],
                      out_bank=m.out_bank.to(device), window=m.window)


def _seq(seed: int, flows: int = sum(SIZES)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (flows, WINDOW, 2), dtype=np.uint8)


def _serve(model, seq: np.ndarray, device) -> tuple[torch.Tensor, dict, object]:
    """The flows of ``seq`` submitted as requests of ``SIZES`` (cycled) to
    an ``AsyncMultiModelServer`` on ``kernel_q8``; the logits in order, the
    serving counters and the plan."""
    srv = AsyncMultiModelServer(backend="kernel_q8", device=device)
    plan = srv.add_model("rnn-b-q8", model)
    offs = np.cumsum([0, *(SIZES * (len(seq) // sum(SIZES)))])
    with srv:
        futs = [srv.submit(InferRequest("rnn-b-q8", seq[a:b])) for a, b in zip(offs, offs[1:])]
        got = torch.cat([torch.as_tensor(np.asarray(f.result(timeout=120).output))
                         for f in futs])
    st = srv.stats()["serving"]
    srv.close()
    return got, st, plan


@pytest.mark.parametrize("depth", [4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_served_on_the_cpu_equals_the_plain_int8_sum(seed, depth):
    model = _rnn(seed=seed, depth=depth)
    seq = _seq(seed)
    got, st, _ = _serve(model, seq, "cpu")
    assert torch.equal(got, _reference(model, seq, INT8))
    assert st["flows_served"] == len(seq)


@pytest.mark.parametrize("levels", [INT4, None], ids=["int4_tables", "f32_tables"])
def test_other_tables_read_far_outside_the_limit(levels):
    """At the published depth, the widest gap from the int8 sum over the
    int8 logits' spread is more than ``MARGIN`` limits: one flipped leaf in
    an early step moves every later step of the chain."""
    model = _rnn(seed=0, depth=8)
    seq = _seq(0)
    want = _reference(model, seq, INT8)
    gap = float((_reference(model, seq, levels) - want).abs().max())
    assert gap / float(want.std(correction=0)) > MARGIN * LIMIT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card_a_replay_launches_sixteen_int8_banks_and_equals_the_plain_sum(card):
    """At the published depth, served on the card: every graph the server
    captured replays 16 ``fuzzy_lut_q8`` launches and no ``fuzzy_lut``, and
    the served logits equal the plain int8 sum computed on the card to the
    bit."""
    model = _rnn(seed=2, depth=8)
    seq = _seq(2, flows=4 * sum(SIZES))
    got, st, plan = _serve(model, seq, card)
    assert torch.equal(got.to(card), _reference(_on(model, card), seq, INT8))
    assert st["flows_served"] == len(seq)
    assert plan._graphs
    for g in plan._graphs.values():
        assert g.launches == {"fuzzy_lut_q8": 16}
