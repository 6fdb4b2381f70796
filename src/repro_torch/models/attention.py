"""GQA/MQA attention with RoPE/M-RoPE, causal + sliding-window masks, and a
decode path over a preallocated KV cache (port of
``repro.models.attention``).

Plain PyTorch ops that mirror the reference's jnp: the scores, the f32
softmax and the online-softmax chunking are written out, not handed to a
fused library operator.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import Params, dense_init, mrope_positions, rope, rope_mrope, zeros

__all__ = ["init_attn", "attn_forward", "attn_decode"]


def init_attn(gen: torch.Generator, d_model: int, num_heads: int, num_kv: int,
              head_dim: int, *, qkv_bias: bool = False, dtype=torch.bfloat16) -> Params:
    p = dict(
        wq=dense_init(gen, (d_model, num_heads * head_dim), dtype=dtype),
        wk=dense_init(gen, (d_model, num_kv * head_dim), dtype=dtype),
        wv=dense_init(gen, (d_model, num_kv * head_dim), dtype=dtype),
        wo=dense_init(gen, (num_heads * head_dim, d_model), dtype=dtype),
    )
    if qkv_bias:
        p.update(bq=zeros(gen, num_heads * head_dim, dtype=dtype),
                 bk=zeros(gen, num_kv * head_dim, dtype=dtype),
                 bv=zeros(gen, num_kv * head_dim, dtype=dtype))
    return Params(**p)


def _project_qkv(p: Params, x, num_heads, num_kv, head_dim):
    b, s, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if "bq" in p:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(b, s, num_heads, head_dim),
            k.reshape(b, s, num_kv, head_dim),
            v.reshape(b, s, num_kv, head_dim))


def _sdpa(q, k, v, mask, *, num_kv_groups: int):
    """q [B,S,H,hd]; k,v [B,T,Kv,hd]; GQA via head grouping. f32 softmax."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(b, s, kv, num_kv_groups, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).to(torch.float32)
    scores = scores / np.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, h, hd)


def _sdpa_chunked(q, k, v, *, num_kv_groups: int, causal: bool,
                  window: int | None, q_chunk: int = 512, kv_chunk: int = 1024):
    """Flash-style chunked attention: online softmax over KV blocks.

    Scores exist only per (q_chunk × kv_chunk) tile. Causality/windowing
    mask fully-masked KV chunks rather than skip them, as the reference.
    q [B,S,H,hd] → out [B,S,H,hd].
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    if s % qc or t % kc:
        raise ValueError(f"chunks must divide the lengths: S={s}, q_chunk={qc}, "
                         f"T={t}, kv_chunk={kc}")
    nq, nk = s // qc, t // kc
    g = num_kv_groups
    scale = 1.0 / np.sqrt(hd)
    dev = q.device

    qr = q.reshape(b, nq, qc, kv, g, hd).permute(1, 0, 3, 4, 2, 5)   # [nq,B,kv,g,qc,hd]
    kr = k.reshape(b, nk, kc, kv, hd).permute(1, 0, 3, 2, 4)         # [nk,B,kv,kc,hd]
    vr = v.reshape(b, nk, kc, kv, hd).permute(1, 0, 3, 2, 4)

    outs = []
    for qi in range(nq):
        qb = qr[qi].to(torch.float32)
        qpos = qi * qc + torch.arange(qc, device=dev)
        m = torch.full((b, kv, g, qc), -torch.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kv, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, g, qc, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            scores = torch.einsum("bkgqh,bkch->bkgqc", qb, kr[ki].to(torch.float32)) * scale
            kpos = ki * kc + torch.arange(kc, device=dev)
            msk = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                msk = kpos[None, :] <= qpos[:, None]
            if window is not None:
                msk = msk & (kpos[None, :] > qpos[:, None] - window)
            scores = torch.where(msk, scores, -1e30)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(scores - m_new[..., None])
            l = l * alpha + pr.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bkch->bkgqh", pr, vr[ki].to(torch.float32))
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, hd)
    return out.to(q.dtype)


def _rotary(q, k, positions, rope_kind: str):
    if rope_kind == "standard":
        return rope(q, positions), rope(k, positions)
    if rope_kind == "mrope":
        pos3 = mrope_positions(positions)
        return rope_mrope(q, pos3), rope_mrope(k, pos3)
    return q, k


def attn_forward(
    p: Params,
    x: torch.Tensor,                   # [B, S, D]
    positions: torch.Tensor,           # [S] or [B, S]
    *,
    num_heads: int,
    num_kv: int,
    head_dim: int,
    causal: bool = True,
    window: int | None = None,
    rope_kind: str = "standard",       # standard | mrope | none
    impl: str = "chunked",             # chunked (flash-style, above 512) | naive
) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, num_heads, num_kv, head_dim)
    q, k = _rotary(q, k, positions, rope_kind)
    if impl == "chunked" and s > 512:
        out = _sdpa_chunked(q, k, v, num_kv_groups=num_heads // num_kv,
                            causal=causal, window=window)
    else:
        mask = None
        if causal:
            i = torch.arange(s, device=x.device)[:, None]
            j = torch.arange(s, device=x.device)[None, :]
            mask = j <= i
            if window is not None:
                mask = mask & (j > i - window)
        out = _sdpa(q, k, v, mask, num_kv_groups=num_heads // num_kv)
    return out.reshape(b, s, num_heads * head_dim) @ p.wo


def attn_decode(
    p: Params,
    x: torch.Tensor,                   # [B, 1, D] — one new token
    cache_k: torch.Tensor,             # [B, T, Kv, hd] preallocated
    cache_v: torch.Tensor,
    pos: int,                          # write index
    *,
    num_heads: int,
    num_kv: int,
    head_dim: int,
    window: int | None = None,
    rope_kind: str = "standard",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against the KV cache; returns (out, cache_k, cache_v).

    Unlike the reference, the caches are written in place (the returned
    caches are the ones passed in): a decode step copies no cache.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, num_heads, num_kv, head_dim)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k = _rotary(q, k, posv, rope_kind)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)

    j = torch.arange(cache_k.shape[1], device=x.device)
    mask = j <= pos
    if window is not None:
        mask = mask & (j > pos - window)
    out = _sdpa(q, cache_k, cache_v, mask, num_kv_groups=num_heads // num_kv)
    return out.reshape(b, 1, num_heads * head_dim) @ p.wo, cache_k, cache_v
