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
from .shape_only import loop_on_meta
from .sharding import (
    add_bias, constrain, dense, is_dtensor, local_region, mesh_dims, replicate, shard_offset,
    split_heads, write_at,
)

__all__ = ["init_attn", "attn_forward", "attn_decode", "SEQ_PARALLEL_ATTN"]

# Sequence-parallel attention: when the KV heads do not divide the "model"
# axis, queries sharded over the sequence on "model" and K/V gathered there
# keep all attention arithmetic local (the reference's knob; default off).
SEQ_PARALLEL_ATTN = False


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


def _project_qkv(p: Params, x, num_heads, num_kv, head_dim, *, stationary: bool = False):
    q, k, v = (dense(x, getattr(p, w), stationary=stationary) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = add_bias(q, p.bq), add_bias(k, p.bk), add_bias(v, p.bv)
    return (split_heads(q, num_heads, head_dim), split_heads(k, num_kv, head_dim),
            split_heads(v, num_kv, head_dim))


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
                  window: int | None, q_chunk: int = 512, kv_chunk: int = 1024,
                  q_offset: int = 0):
    """Flash-style chunked attention: online softmax over KV blocks.

    Scores exist only per (q_chunk × kv_chunk) tile. Causality/windowing
    mask fully-masked KV chunks rather than skip them, as the reference.
    q [B,S,H,hd] → out [B,S,H,hd]; ``q_offset`` is the position of q's
    first row (a sequence shard's).
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    if s % qc or t % kc:
        raise ValueError(f"chunks must divide the lengths: S={s}, q_chunk={qc}, "
                         f"T={t}, kv_chunk={kc}")
    if q.is_meta:       # the dry-run: every tile's QK^T and PV products
        return loop_on_meta([(q.shape, q.dtype)], 4 * b * h * s * t * hd, q, k, v)
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
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
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


def _attend_local(q, k, v, *, num_kv_groups: int, causal: bool = False,
                  window: int | None = None, chunked: bool = False, q_offset: int = 0,
                  mask: torch.Tensor | None = None):
    """Attention of plain q [B,S,H,hd] over k, v [B,T,Kv,hd]; q's rows sit
    at positions ``q_offset + i``; ``mask`` [T] (decode) replaces the
    causal one."""
    if mask is not None:
        return _sdpa(q, k, v, mask, num_kv_groups=num_kv_groups)
    if chunked:
        return _sdpa_chunked(q, k, v, num_kv_groups=num_kv_groups, causal=causal,
                             window=window, q_offset=q_offset)
    mask = None
    if causal:
        i = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = j <= i
        if window is not None:
            mask = mask & (j > i - window)
    return _sdpa(q, k, v, mask, num_kv_groups=num_kv_groups)


def _attend(q, k, v, **kw):
    """Attention of q [B,S,H,hd] over k, v, its heads merged: [B,S,H·hd].
    On DTensors it runs on each rank's shard,
    as tensor-parallel attention does: queries keep their batch, head or
    sequence shards; k and v follow the batch and heads and are gathered
    over a sequence shard; where the query heads split the KV heads
    unevenly (GQA with few KV heads), k and v are gathered over those mesh
    dims and each local query head takes its own KV head. The heads are
    merged on each shard: DTensor cannot view a gradient sharded unevenly
    over the merged dim back into heads (12 heads on an 8-wide axis)."""
    if not is_dtensor(q):
        return _attend_local(q, k, v, **kw).flatten(2)
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    q_pl, kv_pl, head_dims = [], [], []
    for i, pl in enumerate(q.placements):
        if pl in (Shard(0), Shard(1), Shard(2)):
            q_pl.append(pl)
            kv_pl.append(Replicate() if pl == Shard(1) else pl)
            if pl == Shard(2):
                head_dims.append(i)
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    kv_whole = k.shape[2] % int(np.prod([mesh.size(i) for i in head_dims])) == 0
    if not kv_whole:
        kv_pl = [Replicate() if i in head_dims else pl for i, pl in enumerate(kv_pl)]
    _, off = shard_offset(q.shape, mesh, q_pl)
    groups = kw.pop("num_kv_groups")

    def local(ql, kl, vl):
        g = groups
        if not kv_whole:
            heads = torch.arange(off[2], off[2] + ql.shape[2], device=ql.device) // g
            kl, vl, g = kl[:, :, heads], vl[:, :, heads], 1
        return _attend_local(ql, kl, vl, num_kv_groups=g, q_offset=off[1], **kw).flatten(2)

    return local_region(local, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl)


def _cache_layout(k, inner: int):
    """Placements builder for decode against a cache DTensor ``k``: batch
    shards kept, the mesh dims that shard tensor dim ``inner`` of the cache
    given a placement of the caller's, the rest replicated."""
    from torch.distributed.tensor import Replicate, Shard

    batch, inner_dims = mesh_dims(k, 0), mesh_dims(k, inner)

    def pl(on_inner):
        return [Shard(0) if i in batch else on_inner if i in inner_dims else Replicate()
                for i in range(k.device_mesh.ndim)]

    return pl, inner_dims


def _decode_attend(q, k, v, mask, *, num_kv_groups: int):
    """One decode step's attention of q [B,1,H,hd] over the cache, its heads
    merged: [B,1,H·hd]. On a mesh
    each layout of the cache (``decode_state_specs``) runs where it lies:
    KV heads sharded, or none, as tensor-parallel attention (:func:`_attend`);
    head_dim sharded, as GSPMD contracts it: partial scores summed over the
    head_dim shards, the PV product on each shard (:func:`_decode_split_hd`);
    the sequence sharded (``cache_seq_shard``), as split-KV flash-decoding
    (:func:`_decode_split_kv`). The cache itself never moves."""
    if not is_dtensor(k):
        return _sdpa(q, k, v, mask, num_kv_groups=num_kv_groups).flatten(2)
    if mesh_dims(k, 1):
        return _decode_split_kv(q, k, v, mask, num_kv_groups).flatten(2)
    if mesh_dims(k, 3):
        return _decode_split_hd(q, k, v, mask, num_kv_groups).flatten(2)
    return _attend(q, k, v, num_kv_groups=num_kv_groups, mask=mask)


def _scores(ql, kl, g: int, hd: int):
    """Scaled f32 scores [B,Kv,G,S,T] of local q over local k (hd: the full
    head dim, the scale's)."""
    b, s, h, hdl = ql.shape
    q5 = ql.reshape(b, s, kl.shape[2], g, hdl)
    return torch.einsum("bskgh,btkh->bkgst", q5, kl).to(torch.float32) / np.sqrt(hd)


def _decode_split_hd(q, k, v, mask, g: int):
    from torch.distributed.tensor import Partial, Replicate, Shard

    pl, _ = _cache_layout(k, 3)
    hd = q.shape[-1]
    sc = local_region(lambda ql, kl: _scores(ql, kl, g, hd), (q, k),
                      (pl(Shard(3)), pl(Shard(3))), pl(Partial("sum")))

    def pv(scl, vl):
        probs = torch.softmax(torch.where(mask, scl, -1e30), dim=-1).to(vl.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs, vl)
        return out.reshape(*out.shape[:2], -1, vl.shape[-1])

    out = local_region(pv, (sc, v), (pl(Replicate()), pl(Shard(3))), pl(Shard(3)))
    # gathered over head_dim: the caller flattens (heads, head_dim)
    return out.redistribute(k.device_mesh, pl(Replicate()))


def _decode_split_kv(q, k, v, mask, g: int):
    from torch.distributed.tensor import Partial, Replicate, Shard

    pl, seq_dims = _cache_layout(k, 1)
    kpl, rep = pl(Shard(1)), pl(Replicate())
    local_t, off = shard_offset(k.shape, k.device_mesh, kpl)
    lmask = mask[off[1]:off[1] + local_t[1]]
    hd = q.shape[-1]

    # the scores [B, Kv, G, 1, T] once, their T split as the cache's
    spl = pl(Shard(4))
    sc = local_region(lambda ql, kl: torch.where(lmask, _scores(ql, kl, g, hd), -1e30),
                      (q, k), (rep, kpl), spl)
    m = local_region(lambda sl: sl.amax(-1), (sc,), (spl,), pl(Partial("max")))

    def sums(sl, vl, ml):
        pr = torch.exp(sl - ml[..., None])
        return pr.sum(-1), torch.einsum("bkgst,btkh->bskgh", pr, vl.to(torch.float32))

    part = pl(Partial("sum"))
    l, acc = local_region(sums, (sc, v, m), (spl, kpl, rep), (part, part))
    l, acc = l.redistribute(k.device_mesh, rep), acc.redistribute(k.device_mesh, rep)
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(*q.shape).to(q.dtype)


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
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, num_heads, num_kv, head_dim)
    q, k = _rotary(q, k, positions, rope_kind)
    if SEQ_PARALLEL_ATTN and s > 512:
        # the reference's constraints: queries sharded over the sequence on
        # "model", K/V replicated, so the score and PV arithmetic is local
        q = constrain(q, (None, "model", None, None))
        k, v = replicate(k), replicate(v)
    out = _attend(q, k, v, num_kv_groups=num_heads // num_kv, causal=causal, window=window,
                  chunked=impl == "chunked" and s > 512)
    return dense(out, p.wo)


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
    q, k, v = _project_qkv(p, x, num_heads, num_kv, head_dim, stationary=True)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k = _rotary(q, k, posv, rope_kind)
    write_at(cache_k, pos, k[:, 0])
    write_at(cache_v, pos, v[:, 0])

    j = torch.arange(cache_k.shape[1], device=x.device)
    mask = j <= pos
    if window is not None:
        mask = mask & (j > pos - window)
    out = _decode_attend(q, cache_k, cache_v, mask, num_kv_groups=num_heads // num_kv)
    return dense(out, p.wo, stationary=True), cache_k, cache_v
