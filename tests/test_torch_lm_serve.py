"""The port's LM serving path against the JAX reference, on the CPU:
``Server`` / ``make_serve_step`` / ``make_prefill_step``, the Pegasus FFN
(``pegasusify_ffn_layer``, ``pegasus_ffn_apply`` on every path), and a
rehearsal of ``chip_smoke.py``'s LM phase.

The reference's own ``Server`` needs a mesh and fails on its sharded
embedding gather (ROADMAP queue 3), so the oracle is its unsharded
``jax.jit(make_serve_step(cfg))`` looped as ``Server.generate`` loops it.
Weights are the reference's, carried across with
``repro_torch.interop``; inputs come from numpy seeds.

Tolerances per Pegasus path, on banks carried from the reference (same
trees, same bf16 LUT): ``kernel``, ``kernel_q8`` and ``soft`` cast the LUT
to f32 and sum in f32, so they hold to 1e-4; ``gather`` and ``onehot`` sum
to a bf16 result in both frameworks, so they hold to two bf16 ulps
(2^-7 relative).
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.amm import init_pegasus_linear as jinit_pegasus_linear
from repro.launch import serve as jserve
from repro.models import pegasus_layer as jpeg
from repro.models import transformer as jtr
from repro_torch.configs import registry as treg
from repro_torch.core import amm
from repro_torch.core.fuzzy_tree import fit_tree, stack_trees
from repro_torch.interop import lm_params_from_arrays, pegasus_ffn_from_arrays
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import pegasus_layer as tpeg
from repro_torch.models import transformer as ttr

TOL = 1e-4
BF16_TOL = 2.0**-7
CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _models(arch: str, dtype=jnp.float32):
    jcfg, cfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jp = jtr.init_model(jcfg, jax.random.PRNGKey(0), dtype=dtype)
    return jcfg, cfg, jp, lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jp), device=CPU)


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "hymba_1_5b", "xlstm_1_3b", "phi3_5_moe"])
def test_server_generates_the_reference_tokens(arch):
    """8 greedy steps, batch 2: token-identical to the reference's
    ``jit(make_serve_step)`` loop."""
    jcfg, cfg, jp, tp = _models(arch)
    prompts = np.array([[3], [7]], np.int32)
    server = tserve.Server(cfg, device="cpu", kv_len=32, batch_size=2, params=tp)
    got = server.generate(prompts, max_new=8)

    step = jax.jit(jserve.make_serve_step(jcfg))
    state = jtr.init_decode_state(jcfg, 2, 32, dtype=jnp.float32)
    toks, want = jnp.asarray(prompts), [prompts]
    for t in range(8):
        toks, state = step(jp, state, toks, jnp.int32(t))
        want.append(np.asarray(toks))
    want = np.concatenate(want, axis=1)
    assert got.dtype == np.int32 and got.shape == (2, 9)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,s", [("qwen2_vl_2b", 1024), ("granite_20b", 24),
                                    ("whisper_large_v3", 16)])
def test_prefill_step_matches_reference(arch, s):
    """The greedy token after the prompt equals the reference's (Qwen2-VL
    through the chunked attention path at 1024 positions), and the
    last-position logits hold to 1e-4."""
    jcfg, cfg, jp, tp = _models(arch)
    rng = np.random.default_rng(1)
    if cfg.encoder_layers:
        batch = {"embeds": rng.normal(size=(2, s, cfg.d_model)).astype(np.float32),
                 "dec_tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    want = np.asarray(jax.jit(jserve.make_prefill_step(jcfg))(jp, jb))
    got = tserve.make_prefill_step(cfg)(tp, tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    jl, _ = jtr.forward_train(jcfg, jp, jb, last_only=True)
    tl, _ = ttr.forward_train(cfg, tp, tb, last_only=True)
    assert tl.shape == (2, 1, ttr.padded_vocab(cfg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)


def test_server_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.Server(treg.smoke_config("qwen2_vl_2b"))


def test_serve_cli_runs_the_lm_path(capsys):
    tserve.main(["--arch", "qwen2_vl_2b", "--smoke", "--device", "cpu", "--batch", "2",
                 "--max-new", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "device=cpu" in out


def _bank_arrays(bank) -> dict:
    return dict(features=np.asarray(bank.trees.features),
                thresholds=np.asarray(bank.trees.thresholds),
                centroids=np.asarray(bank.trees.centroids), lut=np.asarray(bank.lut),
                bias=None, group_size=bank.group_size)


def _assert_same_trees(got, want):
    np.testing.assert_array_equal(got.trees.features.numpy(), np.asarray(want.trees.features))
    np.testing.assert_array_equal(got.trees.thresholds.numpy(),
                                  np.asarray(want.trees.thresholds))
    np.testing.assert_array_equal(got.trees.centroids.numpy(), np.asarray(want.trees.centroids))


def _assert_lut_within_one_ulp(got, want):
    """bf16 LUTs equal within one bf16 ulp (the f32 products round
    independently in each framework)."""
    assert got.lut.dtype == torch.bfloat16
    a = got.lut.float().numpy()
    b = np.asarray(want.lut.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    assert (np.abs(a - b) <= ulp).all()


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "granite_20b"])
def test_pegasusify_ffn_layer_matches_reference(arch):
    """Gated (Qwen2-VL, silu) and ungated (Granite, gelu) FFNs at smoke
    width: the in/gate trees are exactly the reference's. The out bank is
    calibrated on the hidden activations, which each framework's silu/gelu
    rounds in its own last bit; its trees are exactly the reference's
    ``init_pegasus_linear`` on the port's hidden activations, and those are
    within 1e-5 of the reference's."""
    jcfg, cfg, jp, tp = _models(arch)
    calib = np.random.default_rng(2).normal(size=(256, cfg.d_model)).astype(np.float32)
    jffn = jax.tree.map(lambda a: a[-1], jp["layers"]["ffn"])
    want = jpeg.pegasusify_ffn_layer(jcfg, jffn, calib)
    got = tpeg.pegasusify_ffn_layer(cfg, tp.layers[-1].ffn, calib)
    assert (got.w_gate is None) == (want.w_gate is None) == (not cfg.is_gated_ffn)
    for name in ("w_in", "w_gate"):
        if getattr(want, name) is not None:
            _assert_same_trees(getattr(got, name), getattr(want, name))
            _assert_lut_within_one_ulp(getattr(got, name), getattr(want, name))

    ffn = tp.layers[-1].ffn
    x = torch.as_tensor(calib)
    act = tlayers.activation(cfg.act)
    h = (act(x @ ffn.w_gate) * (x @ ffn.w_in) if "w_gate" in ffn else act(x @ ffn.w_in)).numpy()
    jact = jax.nn.silu if cfg.act == "silu" else (lambda z: jax.nn.gelu(z, approximate=True))
    jx = jnp.asarray(calib)
    jh = (jact(jx @ jffn["w_gate"]) * (jx @ jffn["w_in"]) if "w_gate" in jffn
          else jact(jx @ jffn["w_in"]))
    np.testing.assert_allclose(h, np.asarray(jh), rtol=1e-5, atol=1e-5)
    want_out = jinit_pegasus_linear(np.asarray(jffn["w_out"]), None, h, group_size=4,
                                    depth=4, lut_bits=None, lut_dtype=jnp.bfloat16)
    _assert_same_trees(got.w_out, want_out)
    _assert_lut_within_one_ulp(got.w_out, want_out)


@pytest.fixture(scope="module")
def carried_ffn():
    """The reference's Pegasus FFN of Qwen2-VL's smoke last layer, and the
    same banks carried into the port (bf16 LUTs kept bf16)."""
    jcfg, cfg, jp, _ = _models("qwen2_vl_2b")
    calib = np.random.default_rng(3).normal(size=(256, cfg.d_model)).astype(np.float32)
    want_ffn = jpeg.pegasusify_ffn_layer(jcfg, jax.tree.map(lambda a: a[-1],
                                                            jp["layers"]["ffn"]), calib)
    got_ffn = pegasus_ffn_from_arrays(*(_bank_arrays(getattr(want_ffn, n))
                                        for n in ("w_in", "w_gate", "w_out")),
                                      act=want_ffn.act, device=CPU)
    return cfg, want_ffn, got_ffn


@pytest.mark.parametrize("path,tol", [("gather", BF16_TOL), ("onehot", BF16_TOL),
                                      ("soft", TOL), ("kernel", TOL), ("kernel_q8", TOL)])
def test_pegasus_ffn_apply_matches_reference(carried_ffn, path, tol):
    """Every path of ``pegasus_linear_apply`` through the FFN, on the
    reference's banks carried across."""
    cfg, want_ffn, got_ffn = carried_ffn
    assert all(b.lut.dtype == torch.bfloat16
               for b in (got_ffn.w_in, got_ffn.w_gate, got_ffn.w_out))
    x = np.random.default_rng(6).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    want = np.asarray(jpeg.pegasus_ffn_apply(want_ffn, jnp.asarray(x), path=path))
    got = tpeg.pegasus_ffn_apply(got_ffn, torch.as_tensor(x), path=path)
    assert got.dtype == torch.float32 and got.shape == (2, 8, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_gather_rounds_a_bf16_lut_sum_as_the_reference():
    """On a bf16 LUT the gather path returns the f32 sum rounded to bf16 and
    upcast (the reference's ``sum`` in the LUT's dtype); the kernel path
    keeps the f32 sum."""
    _, cfg, _, tp = _models("qwen2_vl_2b")
    calib = np.random.default_rng(4).normal(size=(256, cfg.d_model)).astype(np.float32)
    bank = tpeg.pegasusify_ffn_layer(cfg, tp.layers[-1].ffn, calib).w_in
    x = torch.as_tensor(calib[:16])
    f32 = dataclasses.replace(bank, lut=bank.lut.float())
    g, k = tpeg.pegasus_linear_apply(bank, x, path="gather"), \
        tpeg.pegasus_linear_apply(bank, x, path="kernel")
    assert torch.equal(k, tpeg.pegasus_linear_apply(f32, x, path="gather"))
    assert torch.equal(g, k.to(torch.bfloat16).float())


def test_lut_and_dense_bytes_match_reference():
    for arch in jreg.ARCH_IDS:
        jcfg, cfg = jreg.get_config(arch), treg.get_config(arch)
        assert tpeg.dense_ffn_bytes(cfg) == jpeg.dense_ffn_bytes(jcfg)
        assert tpeg.dense_ffn_bytes(cfg, 4) == jpeg.dense_ffn_bytes(jcfg, 4)
        for kw in ({}, dict(group_size=4, depth=4, lut_dtype_bytes=2)):
            assert tpeg.lut_bytes(cfg, **kw) == jpeg.lut_bytes(jcfg, **kw), (arch, kw)


def test_parallel_tree_fit_is_the_serial_fit():
    """From 256 groups on, a bank's trees are fit in worker processes; the
    trees are the serial fit's, bit for bit."""
    calib = np.random.default_rng(5).normal(size=(96, 512)).astype(np.float32)
    calib[:, 7] = 1.0                                   # a degenerate group
    assert amm._POOL_MIN_GROUPS == 256
    serial = stack_trees([fit_tree(calib[:, g : g + 2], 3) for g in range(0, 512, 2)])
    pooled = amm.fit_group_trees(calib, 2, 3)
    assert pooled.features.shape == (256, 7)
    for name in ("features", "thresholds", "centroids"):
        assert torch.equal(getattr(serial, name), getattr(pooled, name)), name


def test_lm_params_from_arrays_keeps_bf16():
    """The reference's default bf16 weights arrive as bf16 (f32 norms and
    gates stay f32), exactly, and the port runs a bf16 decode step."""
    jcfg, cfg, jp, tp = _models("phi3_5_moe", dtype=jnp.bfloat16)
    got = dict(tp.named_parameters())
    assert got["embed"].dtype == torch.bfloat16 and got["ln_f"].dtype == torch.float32
    assert got["layers.0.moe.router"].dtype == torch.float32
    np.testing.assert_array_equal(got["layers.1.moe.w_in"].float().numpy(),
                                  np.asarray(jp["layers"]["moe"]["w_in"][1], np.float32))
    state = ttr.init_decode_state(cfg, 2, 16, dtype=torch.bfloat16, device=CPU)
    logits, _ = ttr.decode_step(cfg, tp, state, torch.zeros((2, 1), dtype=torch.int32), 0)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_chip_smoke_lm_phase_rehearses():
    """chip_smoke.py's phase 9 on the CPU at smoke width with a narrow
    Pegasus FFN: prefill, generate, decode against the forward, the FFN on
    every path held to its limits, the nine smoke architectures."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    res = cs.lm_phase(CPU, "the CPU (test)", rehearse=True)
    assert res["dense"]["agree"] == 1.0
    assert res["dense"]["decode_err"] <= cs.LM_DECODE_TOL
    assert {8, 2048} == set(res["pegasus"]["runs"])
    assert all(r["err"] == 0.0 for r in res["pegasus"]["runs"].values())
    assert [a for a, _, _ in res["smoke"]] == [a for a in treg.ARCH_IDS if a != cs.LM_ARCH]
