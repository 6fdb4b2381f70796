"""The port's LM stack (configs and models) against the JAX reference, on
the CPU.

Weights are the reference's ``init_model(PRNGKey(0))`` in f32, carried
across with ``repro_torch.interop.lm_params_from_arrays``; inputs are made
by numpy from a seed and handed to both. The reference runs under
``jax.jit`` without a mesh.

Tolerance: rtol = atol = 1e-4 on f32 values throughout (both frameworks sum
in another order, ~1e-6 relative). The hybrid family (Hymba) is the
tightest: its Mamba state grows to ~60 over 32 steps, so its logits differ
by up to ~7e-5 — still inside the limit, which is therefore not loosened.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch.configs import registry as treg
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr

TOL = 1e-4
B, S = 2, 32
CPU = torch.device("cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _models(arch: str):
    jcfg, cfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jp = jtr.init_model(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, cfg, jp, lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jp), device=CPU)


def _batch(cfg, rng) -> dict:
    if cfg.encoder_layers:
        return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
                "dec_tokens": rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)}
    if cfg.frontend_stub:
        return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jit_decode(arch: str):
    cfg = jreg.smoke_config(arch)
    return jax.jit(lambda p, s, t, pos, e: jtr.decode_step(cfg, p, s, t, pos, enc_out=e))


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_forward_and_decode_match_reference(arch):
    """forward_train logits and the MoE aux value; then 3 decode_steps,
    holding the logits and every state tensor after each step."""
    jcfg, cfg, jp, tp = _models(arch)
    rng = np.random.default_rng(0)
    batch = _batch(cfg, rng)
    jl, ja = jax.jit(lambda p, b: jtr.forward_train(jcfg, p, b))(jp, _jbatch(batch))
    tl, ta = ttr.forward_train(cfg, tp, _tbatch(batch))
    assert tl.shape == (B, jl.shape[1], ttr.padded_vocab(cfg))
    _close(tl, jl)
    _close(ta, ja)
    if cfg.family == "moe":
        assert float(ta) > 0

    enc = (rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
           if cfg.encoder_layers else None)
    js = jtr.init_decode_state(jcfg, B, 64, dtype=jnp.float32)
    ts = ttr.init_decode_state(cfg, B, 64, dtype=torch.float32, device=CPU)
    assert sorted(ts) == sorted(js)
    step = _jit_decode(arch)
    for t in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jlog, js = step(jp, js, jnp.asarray(tok), jnp.int32(t),
                        None if enc is None else jnp.asarray(enc))
        tlog, ts = ttr.decode_step(cfg, tp, ts, torch.as_tensor(tok), t,
                                   enc_out=None if enc is None else torch.as_tensor(enc))
        _close(tlog, jlog)
        for key in js:
            assert ts[key].shape == js[key].shape, key
            _close(ts[key], js[key])


def test_windowed_decode_past_the_ring():
    """Hymba smoke (window 32): 40 decode steps, 8 past the ring. The port
    keeps the reference's behaviour: rotary and the mask use the ring's
    write index, not the absolute position."""
    jcfg, cfg, jp, tp = _models("hymba_1_5b")
    assert cfg.window == 32
    rng = np.random.default_rng(1)
    js = jtr.init_decode_state(jcfg, B, 512, dtype=jnp.float32)
    ts = ttr.init_decode_state(cfg, B, 512, dtype=torch.float32, device=CPU)
    assert ts["cache_k"].shape[2] == 32
    step = _jit_decode("hymba_1_5b")
    for t in range(40):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jlog, js = step(jp, js, jnp.asarray(tok), jnp.int32(t), None)
        tlog, ts = ttr.decode_step(cfg, tp, ts, torch.as_tensor(tok), t)
        _close(tlog, jlog)
    _close(ts["cache_k"], js["cache_k"])
    _close(ts["mamba_h"], js["mamba_h"])


def test_whisper_decodes_against_encoder_output():
    """Enc-dec: 5 decode steps attending to an encoder output, and the same
    steps without one (the reference skips the cross attention)."""
    jcfg, cfg, jp, tp = _models("whisper_large_v3")
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(B, 24, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (5, B, 1)).astype(np.int32)
    step = _jit_decode("whisper_large_v3")
    for e in (enc, None):
        js = jtr.init_decode_state(jcfg, B, 64, dtype=jnp.float32)
        ts = ttr.init_decode_state(cfg, B, 64, dtype=torch.float32, device=CPU)
        for t in range(5):
            jlog, js = step(jp, js, jnp.asarray(toks[t]), jnp.int32(t),
                            None if e is None else jnp.asarray(e))
            tlog, ts = ttr.decode_step(cfg, tp, ts, torch.as_tensor(toks[t]), t,
                                       enc_out=None if e is None else torch.as_tensor(e))
            _close(tlog, jlog)


def test_sdpa_chunked_matches_reference():
    """Online softmax over KV blocks at S = 1,100 with a window (chunks that
    divide 1,100), against the reference and the port's unchunked path."""
    rng = np.random.default_rng(3)
    s, h, kv, hd, window = 1100, 4, 2, 16, 300
    q = rng.normal(size=(1, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(1, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(1, s, kv, hd)).astype(np.float32)
    kw = dict(num_kv_groups=h // kv, causal=True, window=window, q_chunk=220, kv_chunk=550)
    want = jattn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tattn._sdpa_chunked(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), **kw)
    _close(got, want)
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = torch.as_tensor((j <= i) & (j > i - window))
    naive = tattn._sdpa(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), mask,
                        num_kv_groups=h // kv)
    _close(got, naive)
    with pytest.raises(ValueError, match="chunks must divide"):
        tattn._sdpa_chunked(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                            num_kv_groups=2, causal=True, window=None)


def test_attn_forward_takes_the_chunked_path_above_512():
    """attn_forward switches to the chunked path at s > 512 (1024 here,
    M-RoPE and QKV bias as in Qwen2-VL), equal to the reference's."""
    rng = np.random.default_rng(4)
    d, h, kv, hd, s = 64, 4, 2, 16, 1024
    jp = jattn.init_attn(jax.random.PRNGKey(5), d, h, kv, hd, qkv_bias=True,
                         dtype=jnp.float32)
    jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    tp = tlayers.Params(**{k: torch.tensor(np.asarray(v)) for k, v in jp.items()})
    x = rng.normal(size=(1, s, d)).astype(np.float32)
    kw = dict(num_heads=h, num_kv=kv, head_dim=hd, rope_kind="mrope")
    want = jattn.attn_forward(jp, jnp.asarray(x), jnp.arange(s), **kw)
    got = tattn.attn_forward(tp, torch.as_tensor(x), torch.arange(s), **kw)
    _close(got, want)
    naive = tattn.attn_forward(tp, torch.as_tensor(x), torch.arange(s), impl="naive", **kw)
    _close(got, naive)


@pytest.mark.parametrize("name", ["silu", "gelu", "sq_relu", "relu"])
def test_activations_match_reference(name):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    _close(tlayers.activation(name)(torch.as_tensor(x)),
           jlayers.activation(name)(jnp.asarray(x)), tol=1e-6)


def test_norm_and_rotary_match_reference():
    """rms_norm, split-halves rope over [S] and [B, S] positions, and the
    sectioned M-RoPE (sections (2, 1, 1), as the reference)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 40, 3, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    _close(tlayers.rms_norm(torch.as_tensor(x), torch.as_tensor(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), tol=1e-6)
    for pos in (np.arange(40) + 900, np.tile(np.arange(40), (2, 1))):
        _close(tlayers.rope(torch.as_tensor(x), torch.as_tensor(pos)),
               jlayers.rope(jnp.asarray(x), jnp.asarray(pos)))
        pos3 = np.stack([pos, pos, pos])
        _close(tlayers.rope_mrope(torch.as_tensor(x), torch.as_tensor(pos3)),
               jlayers.rope_mrope(jnp.asarray(x), jnp.asarray(pos3)))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_matches_reference(capacity_factor):
    """Grouped capacity dispatch, top-k renormalisation and aux loss, with
    drops (capacity 0.5) and without. Router inputs are continuous random
    draws, so no two expert probabilities tie and top-k order is decided."""
    rng = np.random.default_rng(7)
    d, f, e, k = 16, 32, 4, 2
    jp = jmoe.init_moe(jax.random.PRNGKey(8), d, f, e, gated=True, dtype=jnp.float32)
    tp = tlayers.Params(**{n: torch.tensor(np.asarray(v)) for n, v in jp.items()})
    x = rng.normal(size=(2, 64, d)).astype(np.float32)
    kw = dict(top_k=k, act="silu", capacity_factor=capacity_factor, group_size=32)
    jy, ja = jmoe.moe_forward(jp, jnp.asarray(x), **kw)
    ty, ta = tmoe.moe_forward(tp, torch.as_tensor(x), **kw)
    _close(ty, jy)
    _close(ta, ja)
    with pytest.raises(ValueError, match="groups of"):
        tmoe.moe_forward(tp, torch.as_tensor(x[:, :63]), **kw)


def test_chunked_scans_refuse_the_lengths_the_reference_refuses():
    """mLSTM asserts s % chunk == 0 and the mamba head cannot reshape such a
    length in the reference; the port raises for the same lengths and runs
    the lengths that divide."""
    rng = np.random.default_rng(9)
    jm = jssm.init_mamba_head(jax.random.PRNGKey(1), 16, 32, 4, dtype=jnp.float32)
    tm = tlayers.Params(**{n: torch.tensor(np.asarray(v)) for n, v in jm.items()})
    x = rng.normal(size=(1, 300, 16)).astype(np.float32)
    with pytest.raises(TypeError):
        jssm.mamba_forward(jm, jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.mamba_forward(tm, torch.as_tensor(x))
    jl = jssm.init_mlstm(jax.random.PRNGKey(2), 16, 2, 8, dtype=jnp.float32)
    tl = tlayers.Params(**{n: torch.tensor(np.asarray(v)) for n, v in jl.items()})
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.mlstm_forward(tl, torch.as_tensor(x), num_heads=2, head_dim=8)
    x = x[:, :256]
    _close(tssm.mamba_forward(tm, torch.as_tensor(x)), jssm.mamba_forward(jm, jnp.asarray(x)))
    _close(tssm.mlstm_forward(tl, torch.as_tensor(x), num_heads=2, head_dim=8, chunk=64),
           jssm.mlstm_forward(jl, jnp.asarray(x), num_heads=2, head_dim=8, chunk=64))


def test_configs_match_reference():
    """The ten configs value for value, full and smoke, with the reference's
    parameter counts."""
    assert treg.ARCH_IDS == jreg.ARCH_IDS and treg.SHAPES == jreg.SHAPES
    for arch in jreg.ARCH_IDS:
        for get in ("get_config", "smoke_config"):
            got, want = getattr(treg, get)(arch), getattr(jreg, get)(arch)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, get)
            assert got.resolved_head_dim == want.resolved_head_dim
            assert got.is_gated_ffn == want.is_gated_ffn
        got, want = treg.get_config(arch), jreg.get_config(arch)
        assert got.param_count() == want.param_count(), arch
        assert got.active_param_count() == want.active_param_count(), arch
        assert ttr.padded_vocab(got) == jtr.padded_vocab(want)


def test_init_model_draws_the_reference_shapes():
    """The port's seeded init builds the reference's tree: the same keys,
    shapes and dtypes per layer (bf16 weights, f32 norms/gates/router)."""
    for arch in jreg.ARCH_IDS:
        jcfg, cfg = jreg.smoke_config(arch), treg.smoke_config(arch)
        jp = jax.eval_shape(lambda: jtr.init_model(jcfg, jax.random.PRNGKey(0)))
        tp = ttr.init_model(cfg, 3, device=CPU)
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            keys = [p.key for p in path]
            if keys[0] in ("layers", "enc_layers"):
                want[".".join([keys[0], "0"] + keys[1:])] = (leaf.shape[1:], leaf.dtype.name)
            else:
                want[".".join(keys)] = (leaf.shape, leaf.dtype.name)
        got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
               for n, p in tp.named_parameters()
               if not n.startswith(("layers.", "enc_layers.")) or n.split(".")[1] == "0"}
        assert got == want, arch
        assert not any(p.requires_grad for p in tp.parameters())
