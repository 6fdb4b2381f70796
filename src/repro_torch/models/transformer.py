"""The LM stack (port of ``repro.models.transformer``): one composable
decoder/enc-dec covering the ten configured architectures (dense / MoE /
SSM / hybrid / enc-dec / VLM-backbone).

A model is a :class:`~repro_torch.models.layers.Params` tree under the
reference's key names, its per-layer blocks in an ``nn.ModuleList``
(``layers``, and ``enc_layers`` for enc-dec) where the reference stacks
them over a leading ``[L, ...]`` axis for ``lax.scan``; Python loops over
the layers replace the scans, and ``torch.utils.checkpoint`` around each
layer replaces ``jax.checkpoint`` on the scan body (``remat_policy``).
Each dense FFN is an :class:`FFN` module, so a forward hook on it sees its
input. Decode runs one token against preallocated caches/states, stacked
over depth as in the reference and updated in place.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.registry import ArchConfig
from repro_torch.device import resolve_device

from .attention import _attend, attn_decode, attn_forward, init_attn
from .layers import Params, activation, dense_init, ones, rms_norm
from .moe import init_moe, moe_forward
from .sharding import (
    batch_only, constrain, dense, implicit, is_dtensor, like, split_heads, split_tokens,
    vocab_parallel_ce_terms, vocab_parallel_embed,
)
from .ssm import (
    init_mamba_head, init_mlstm, init_slstm,
    mamba_decode_step, mamba_forward,
    mlstm_decode_step, mlstm_forward,
    slstm_decode_step, slstm_forward,
)

__all__ = ["FFN", "init_model", "forward_train", "lm_loss", "init_decode_state",
           "decode_step", "padded_vocab", "LAYER_SEQ_SHARD", "DECODE_FEATURE_SHARD"]

# Decode knob: shard the residual stream's feature dim over "data" in each
# decode layer. With weights 2D-sharded [D/data, F/model] every product
# contracts its slice of D and reduces only its [B, 1, F/model] output;
# plain decode keeps the rows on "data" and its products turn them into
# such slices first (``sharding.dense(stationary=True)``), so neither moves
# a weight (the reference's knob; it acts on DTensors only).
DECODE_FEATURE_SHARD = False

# Prefill/train knob: keep activations sequence-sharded on "model" at layer
# boundaries (Megatron-SP), so sequence-parallel attention does not
# reshard the [B, S, D] residual stream between attention and the FFN.
LAYER_SEQ_SHARD = False


def _decode_boundary(x):
    """The decode stream's layout at each layer on a mesh: its rows on the
    batch's mesh dims (pending sums of the embedding reduced), or its
    features on "data" with the ``DECODE_FEATURE_SHARD`` knob."""
    return constrain(x, (None, None, "data")) if DECODE_FEATURE_SHARD else batch_only(x)


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab rounded to a multiple of 256 (the reference shards it on any
    mesh axis; the logits keep that width, padded ids included)."""
    return int(np.ceil(cfg.vocab_size / 256)) * 256


class FFN(Params):
    """One dense (optionally gated) FFN: ``act(x@w_gate) * (x@w_in) @ w_out``.

    Called as a module (``p(x)``), so a forward hook sees its input. On a
    mesh each product takes :func:`~.sharding.dense`'s stated strategy;
    ``stationary`` (the decode step) keeps the weights where they lie.
    """

    def __init__(self, act: str, **weights):
        super().__init__(**weights)
        self.act = act

    def forward(self, x: torch.Tensor, *, stationary: bool = False) -> torch.Tensor:
        act = activation(self.act)
        h = act(dense(x, self.w_gate if "w_gate" in self else self.w_in,
                      stationary=stationary))
        if "w_gate" in self:
            h = h * dense(x, self.w_in, stationary=stationary)
        return dense(h, self.w_out, stationary=stationary)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_ffn(gen, cfg: ArchConfig, dtype) -> FFN:
    p = dict(w_in=dense_init(gen, (cfg.d_model, cfg.d_ff), dtype=dtype),
             w_out=dense_init(gen, (cfg.d_ff, cfg.d_model), dtype=dtype))
    if cfg.is_gated_ffn:
        p["w_gate"] = dense_init(gen, (cfg.d_model, cfg.d_ff), dtype=dtype)
    return FFN(cfg.act, **p)


def _init_layer(gen, cfg: ArchConfig, dtype, *, cross: bool = False) -> Params:
    """One decoder layer's params (family-dependent)."""
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    p: dict[str, Any] = {"ln1": ones(gen, d)}
    if cfg.family == "ssm":
        # xLSTM super-layer: mLSTM + sLSTM
        p["mlstm"] = init_mlstm(gen, d, cfg.num_heads, hd, dtype)
        p["ln_s"] = ones(gen, d)
        p["slstm"] = init_slstm(gen, d, dtype)
        return Params(**p)
    p["attn"] = init_attn(gen, d, cfg.num_heads, cfg.num_kv_heads, hd,
                          qkv_bias=cfg.qkv_bias, dtype=dtype)
    if cfg.family == "hybrid":
        p["mamba"] = init_mamba_head(gen, d, 2 * d, cfg.ssm_state, dtype)
    if cross:
        p["ln_x"] = ones(gen, d)
        p["xattn"] = init_attn(gen, d, cfg.num_heads, cfg.num_kv_heads, hd, dtype=dtype)
    p["ln2"] = ones(gen, d)
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, d, cfg.d_ff, cfg.num_experts,
                            gated=cfg.is_gated_ffn, dtype=dtype)
    elif cfg.d_ff:
        p["ffn"] = _init_ffn(gen, cfg, dtype)
    return Params(**p)


def init_model(cfg: ArchConfig, seed: int = 0, *, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> Params:
    """Full parameter tree, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (other numbers than the reference's
    ``PRNGKey(seed)``; carry its weights across with
    :func:`repro_torch.interop.lm_params_from_arrays`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    v = padded_vocab(cfg)
    params: dict[str, Any] = {"embed": dense_init(gen, (v, cfg.d_model), dtype=dtype),
                              "ln_f": ones(gen, cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, v), dtype=dtype)
    cross = cfg.encoder_layers > 0
    params["layers"] = nn.ModuleList(
        _init_layer(gen, cfg, dtype, cross=cross) for _ in range(cfg.num_layers))
    if cfg.encoder_layers:
        params["enc_layers"] = nn.ModuleList(
            _init_layer(gen, cfg, dtype) for _ in range(cfg.encoder_layers))
        params["enc_ln_f"] = ones(gen, cfg.d_model)
    return Params(**params)


# ---------------------------------------------------------------------------
# layer forwards (full-sequence)
# ---------------------------------------------------------------------------


def _layer_forward(cfg: ArchConfig, p: Params, x, positions, *, causal, enc_out=None):
    """One layer, full sequence. Returns (x, aux)."""
    with implicit(p.ln1):      # also around remat's recompute in the backward
        return _layer_body(cfg, p, x, positions, causal=causal, enc_out=enc_out)


def _layer_body(cfg: ArchConfig, p: Params, x, positions, *, causal, enc_out=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        x = x + like(mlstm_forward(p.mlstm, rms_norm(x, p.ln1),
                                   num_heads=cfg.num_heads, head_dim=hd), x)
        x = x + like(slstm_forward(p.slstm, rms_norm(x, p.ln_s)), x)
        return x, aux

    h = rms_norm(x, p.ln1)
    attn_out = attn_forward(
        p.attn, h, positions,
        num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads, head_dim=hd,
        causal=causal, window=cfg.window or None, rope_kind=cfg.rope_kind,
    )
    if cfg.family == "hybrid":
        attn_out = like(attn_out, x) + like(mamba_forward(p.mamba, h), x)
    x = x + like(attn_out, x)

    if enc_out is not None:
        x = x + like(_cross_attn(cfg, p.xattn, rms_norm(x, p.ln_x), enc_out), x)

    h2 = rms_norm(x, p.ln2)
    if cfg.family == "moe":
        ffn_out, aux = moe_forward(p.moe, h2, top_k=cfg.top_k, act=cfg.act)
    elif cfg.d_ff:
        ffn_out = p.ffn(h2)
    else:
        return x, aux
    return x + like(ffn_out, x), aux


def _cross_attn(cfg: ArchConfig, p: Params, q_in, enc_out, *, stationary: bool = False):
    """Whisper-style cross attention (no rope, keys from encoder output)."""
    hd = cfg.resolved_head_dim
    kw = dict(stationary=stationary)
    q = split_heads(dense(q_in, p.wq, **kw), cfg.num_heads, hd)
    k = split_heads(dense(enc_out, p.wk, **kw), cfg.num_kv_heads, hd)
    v = split_heads(dense(enc_out, p.wv, **kw), cfg.num_kv_heads, hd)
    out = _attend(q, k, v, num_kv_groups=cfg.num_heads // cfg.num_kv_heads)
    return dense(out, p.wo, **kw)


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-np.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                      device=positions.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# full-model forward (training / prefill)
# ---------------------------------------------------------------------------


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(_ctx, op, *_args, **_kwargs) -> CheckpointPolicy:
    """``dots_with_no_batch_dims_saveable``: keep the products without a
    batch dimension (the weight matmuls), recompute the rest (attention's
    and the experts' batched products included)."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat_policy: str):
    """``fn`` under the reference's remat policy: ``"nothing"`` saves only
    the layer's inputs and recomputes the layer in the backward, ``"dots"``
    also saves its weight products, anything else saves every activation.
    Remat changes memory, never values; without autograd it is skipped."""
    if not torch.is_grad_enabled() or remat_policy not in ("nothing", "dots"):
        return fn
    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _layer_boundary(x):
    """The residual stream's layout between layers on a mesh:
    :func:`~.sharding.split_tokens`, or the ``LAYER_SEQ_SHARD`` knob's."""
    if LAYER_SEQ_SHARD and x.shape[1] >= 1024:
        return constrain(x, (None, "model", None))
    return split_tokens(x)


def _run_layers(cfg, layers, x, positions, *, causal, enc_out=None,
                remat_policy: str = "nothing"):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = _layer_boundary(x)
    for p in layers:
        body = _remat(functools.partial(_layer_forward, cfg, p, causal=causal), remat_policy)
        x, a = body(x, positions, enc_out=enc_out)
        x = _layer_boundary(x)
        aux = aux + a
    return x, aux


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(params.embed):
        return vocab_parallel_embed(params.embed, tokens)
    return params.embed[tokens.long()]


def _logits(cfg: ArchConfig, params: Params, x, *, stationary: bool = False):
    """The LM head's product. On a mesh its input keeps only its batch
    shards (``batch_only``), so the [D, V] head is gathered over the fsdp
    axes (or, in the decode step, stays and the few rows move) and the
    vocab splits over "model": the [B, S, V/model] logits are the largest
    tensors a prefill_32k rank holds."""
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return dense(x, w, stationary=stationary)


def _on_mesh(fn):
    """Run ``fn(cfg, params, ...)`` in :func:`~.sharding.implicit` when the
    parameters are DTensors."""
    @functools.wraps(fn)
    def wrapped(cfg, params, *args, **kwargs):
        with implicit(params.embed):
            return fn(cfg, params, *args, **kwargs)

    return wrapped


@_on_mesh
def forward_train(cfg: ArchConfig, params: Params, batch: dict, *,
                  remat_policy: str = "nothing",
                  last_only: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B,S,V], moe_aux). ``batch`` carries ``tokens`` or
    (stub frontends) ``embeds``; enc-dec additionally ``dec_tokens``.
    ``remat_policy`` (``"nothing"``, ``"dots"`` or any other value for no
    remat) applies per layer when autograd records. ``last_only`` keeps only
    the last position before the LM head (prefill serving reads nothing
    else)."""
    dtype = params.embed.dtype
    if cfg.encoder_layers:
        # whisper: encoder over frame embeddings, decoder over text tokens
        enc_x = batch["embeds"].to(dtype)
        s_enc = enc_x.shape[1]
        pos_enc = torch.arange(s_enc, device=enc_x.device)
        enc_x = enc_x + _sinusoid(pos_enc, cfg.d_model).to(dtype)
        enc_x, _ = _run_layers(cfg, params.enc_layers, enc_x, pos_enc, causal=False,
                               remat_policy=remat_policy)
        enc_out = rms_norm(enc_x, params.enc_ln_f)

        dec_tokens = batch["dec_tokens"]
        pos = torch.arange(dec_tokens.shape[1], device=dec_tokens.device)
        x = _embed(params, dec_tokens) + _sinusoid(pos, cfg.d_model).to(dtype)
        x, aux = _run_layers(cfg, params.layers, x, pos, causal=True, enc_out=enc_out,
                             remat_policy=remat_policy)
    else:
        if "embeds" in batch:           # vlm stub frontend
            x = batch["embeds"].to(dtype)
        else:
            x = _embed(params, batch["tokens"])
        pos = torch.arange(x.shape[1], device=x.device)
        x, aux = _run_layers(cfg, params.layers, x, pos, causal=True,
                             remat_policy=remat_policy)

    x = batch_only(rms_norm(x, params.ln_f))
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x), aux


@_on_mesh
def lm_loss(cfg: ArchConfig, params: Params, batch: dict, *,
            remat_policy: str = "nothing", z_loss: float = 1e-4,
            aux_weight: float = 1e-2) -> torch.Tensor:
    """Next-token cross-entropy over the padded vocab, plus ``z_loss`` times
    the mean squared log-partition and ``aux_weight`` times the MoE
    auxiliary loss; ``batch["labels"]`` holds the targets."""
    logits, aux = forward_train(cfg, params, batch, remat_policy=remat_policy)
    if is_dtensor(logits):
        logz, picked = vocab_parallel_ce_terms(logits, batch["labels"])
    else:
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    logp = picked - logz
    return -logp.mean() + z_loss * torch.square(logz).mean() + aux_weight * aux


# ---------------------------------------------------------------------------
# decode (one token against caches/states)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch: int, kv_len: int, *,
                      dtype=torch.bfloat16,
                      device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Preallocated per-layer caches/states, stacked over depth."""
    dev = resolve_device(device)
    l, hd, kv = cfg.num_layers, cfg.resolved_head_dim, cfg.num_kv_heads
    f32 = torch.float32

    def z(*shape, dt=f32):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family == "ssm":
        return dict(mlstm_S=z(l, batch, cfg.num_heads, hd, hd),
                    mlstm_n=z(l, batch, cfg.num_heads, hd),
                    slstm_c=z(l, batch, cfg.d_model), slstm_n=z(l, batch, cfg.d_model),
                    slstm_h=z(l, batch, cfg.d_model, dt=dtype))
    cache_len = min(kv_len, cfg.window) if cfg.window else kv_len
    if cfg.encoder_layers:
        cache_len = min(kv_len, cfg.max_decoder_len)
    st = dict(cache_k=z(l, batch, cache_len, kv, hd, dt=dtype),
              cache_v=z(l, batch, cache_len, kv, hd, dt=dtype))
    if cfg.family == "hybrid":
        st["mamba_h"] = z(l, batch, 2 * cfg.d_model, cfg.ssm_state)
    return st


@_on_mesh
def decode_step(cfg: ArchConfig, params: Params, state: dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: int, *,
                enc_out: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step for ``tokens`` [B, 1] at absolute position ``pos``.
    Returns (logits [B, V] f32, state); ``state`` is updated in place.

    As in the reference, a windowed or enc-dec model writes its ring at
    ``pos mod cache_len`` and passes that write index (not ``pos``) to the
    attention as the rotary position and the mask's bound.
    """
    hd = cfg.resolved_head_dim
    x = _embed(params, tokens)      # [B, 1, D]
    if cfg.encoder_layers:
        posv = torch.tensor([pos], device=x.device)
        x = x + _sinusoid(posv, cfg.d_model).to(x.dtype)[None]

    if cfg.family == "ssm":
        for l, p in enumerate(params.layers):
            out, S, n = mlstm_decode_step(
                p.mlstm, rms_norm(x, p.ln1), state["mlstm_S"][l], state["mlstm_n"][l],
                num_heads=cfg.num_heads, head_dim=hd)
            x = x + out
            out, c, ns, hs = slstm_decode_step(
                p.slstm, rms_norm(x, p.ln_s), state["slstm_c"][l], state["slstm_n"][l],
                state["slstm_h"][l])
            x = x + out
            for key, val in (("mlstm_S", S), ("mlstm_n", n), ("slstm_c", c),
                             ("slstm_n", ns), ("slstm_h", hs)):
                state[key][l] = val
    else:
        cache_len = state["cache_k"].shape[2]
        write_pos = pos % cache_len if (cfg.window or cfg.encoder_layers) else pos
        for l, p in enumerate(params.layers):
            x = _decode_boundary(x)
            hn = rms_norm(x, p.ln1)
            out, _, _ = attn_decode(
                p.attn, hn, state["cache_k"][l], state["cache_v"][l], write_pos,
                num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads, head_dim=hd,
                window=None,  # ring buffer already bounds the window
                rope_kind=cfg.rope_kind,
            )
            if cfg.family == "hybrid":
                mo, state["mamba_h"][l] = mamba_decode_step(p.mamba, hn, state["mamba_h"][l])
                out = like(out, x) + like(mo, x)
            x = x + like(out, x)
            if enc_out is not None:
                x = x + like(_cross_attn(cfg, p.xattn, rms_norm(x, p.ln_x), enc_out,
                                         stationary=True), x)
            h2 = rms_norm(x, p.ln2)
            if cfg.family == "moe":
                f, _ = moe_forward(p.moe, h2, top_k=cfg.top_k, act=cfg.act)
                x = x + like(f, x)
            elif cfg.d_ff:
                x = x + like(p.ffn(h2, stationary=True), x)

    x = batch_only(rms_norm(x, params.ln_f))
    return _logits(cfg, params, x[:, 0], stationary=True).to(torch.float32), state
