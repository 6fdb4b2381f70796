"""Recurrent blocks (port of ``repro.models.ssm``): xLSTM's mLSTM
(chunked-parallel) + sLSTM (sequential), and a simplified Mamba-style
selective-SSM head for Hymba's hybrid layers.

mLSTM uses the chunkwise-parallel form (matrix state S ∈ R^{dk×dv}, scalar
sigmoid gates per head): within a chunk the decay matrix is materialized
and everything is batched matmuls; across chunks a Python loop carries
(S, n). Python loops take the place of the reference's ``lax.scan``s.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from .layers import Params, dense_init, zeros
from .shape_only import loop_on_meta
from .sharding import tp_region

__all__ = [
    "init_mlstm", "mlstm_forward", "mlstm_decode_step",
    "init_slstm", "slstm_forward", "slstm_decode_step",
    "init_mamba_head", "mamba_forward", "mamba_decode_step",
]

_F32 = torch.float32


def _input_gate(z: torch.Tensor) -> torch.Tensor:
    """exp(-softplus(-z)), the reference's sigmoid input gate."""
    return torch.exp(-F.softplus(-z))


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block)
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, d_model: int, num_heads: int, head_dim: int,
               dtype=torch.bfloat16) -> Params:
    hd = head_dim
    return Params(
        wq=dense_init(gen, (d_model, num_heads * hd), dtype=dtype),
        wk=dense_init(gen, (d_model, num_heads * hd), dtype=dtype),
        wv=dense_init(gen, (d_model, num_heads * hd), dtype=dtype),
        wi=dense_init(gen, (d_model, num_heads), dtype=_F32),
        wf=dense_init(gen, (d_model, num_heads), dtype=_F32),
        wo_gate=dense_init(gen, (d_model, num_heads * hd), dtype=dtype),
        wo=dense_init(gen, (num_heads * hd, d_model), dtype=dtype),
    )


def _mlstm_chunk(q, k, v, logf, i_gate, carry_S, carry_n):
    """One chunk. q,k,v: [B,H,c,hd]; logf,i: [B,H,c]; S: [B,H,hd,hd]; n: [B,H,hd]."""
    c = q.shape[2]
    q, k, v = q.to(_F32), k.to(_F32), v.to(_F32)
    l = torch.cumsum(logf, dim=-1)                       # [B,H,c] cumulative log decay
    # intra-chunk: A[j,u] = exp(l_j - l_u) * i_u   (u <= j)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    amat = torch.where(mask, torch.exp(l[..., :, None] - l[..., None, :]), 0.0) \
        * i_gate[..., None, :]
    scores = torch.einsum("bhjd,bhud->bhju", q, k)
    intra = torch.einsum("bhju,bhud->bhjd", scores * amat, v)
    # inter-chunk: decayed carry
    decay_j = torch.exp(l)[..., None]                    # [B,H,c,1]
    inter = torch.einsum("bhjd,bhde->bhje", q, carry_S) * decay_j
    # normalizer n_j = exp(l_j) n_prev + Σ_{u≤j} exp(l_j−l_u) i_u k_u
    n_intra = torch.einsum("bhju,bhud->bhjd", amat, k)
    n_j = decay_j * carry_n[..., None, :] + n_intra
    denom = torch.abs(torch.einsum("bhjd,bhjd->bhj", q, n_j))
    h = (intra + inter) / torch.clamp(denom, min=1.0)[..., None]
    # carry update
    decay_c = torch.exp(l[..., -1])[..., None, None]     # [B,H,1,1]
    w_u = torch.exp(l[..., -1:] - l) * i_gate            # [B,H,c]
    S_new = decay_c * carry_S + torch.einsum("bhud,bhue,bhu->bhde", k, v, w_u)
    n_new = decay_c[..., 0] * carry_n + torch.einsum("bhud,bhu->bhd", k, w_u)
    return h, S_new, n_new


def mlstm_forward(p: Params, x: torch.Tensor, *, num_heads: int, head_dim: int,
                  chunk: int = 256) -> torch.Tensor:
    """Full-sequence chunked mLSTM. x: [B, S, D] → [B, S, D]. On a mesh it
    runs tensor-parallel over the heads (see :func:`~.sharding.tp_region`)."""
    ws = (p.wq, p.wk, p.wv, p.wi, p.wf, p.wo_gate, p.wo)
    return tp_region(_mlstm, x, ws, (1, 1, 1, 1, 1, 1, 0), num_heads,
                     num_heads=num_heads, head_dim=head_dim, chunk=chunk)


def _mlstm(x, wq, wk, wv, wi, wf, wo_gate, wo, *, num_heads: int, head_dim: int,
           chunk: int) -> torch.Tensor:
    """The mLSTM on plain tensors over the heads ``wq``'s columns hold."""
    b, s, _ = x.shape
    hd = head_dim
    num_heads = wi.shape[1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {c}")

    def heads(w):
        return (x @ w).reshape(b, s, num_heads, hd).transpose(1, 2)

    q, k, v = heads(wq) / np.sqrt(hd), heads(wk), heads(wv)
    logf = F.logsigmoid(x.to(_F32) @ wf).transpose(1, 2)              # [B,H,S]
    i_gate = _input_gate(x.to(_F32) @ wi).transpose(1, 2)

    S = torch.zeros((b, num_heads, hd, hd), dtype=_F32, device=x.device)
    n = torch.zeros((b, num_heads, hd), dtype=_F32, device=x.device)
    hs = []
    for j in range(s // c):
        sl = slice(j * c, (j + 1) * c)
        h, S, n = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                               logf[..., sl], i_gate[..., sl], S, n)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(b, s, num_heads * hd)
    o = torch.sigmoid(x @ wo_gate)
    return ((h.to(x.dtype) * o) @ wo).to(x.dtype)


def mlstm_decode_step(p: Params, x: torch.Tensor, S: torch.Tensor, n: torch.Tensor,
                      *, num_heads: int, head_dim: int):
    """One-token step. x: [B, 1, D]; S: [B,H,hd,hd]; n: [B,H,hd]."""
    b = x.shape[0]
    hd = head_dim
    xt = x[:, 0]

    def head(w):
        return (xt @ w).reshape(b, num_heads, hd)

    q, k, v = head(p.wq) / np.sqrt(hd), head(p.wk), head(p.wv)
    q, k, v = q.to(_F32), k.to(_F32), v.to(_F32)
    f = torch.sigmoid(xt.to(_F32) @ p.wf)                             # [B,H]
    i = _input_gate(xt.to(_F32) @ p.wi)
    S = f[..., None, None] * S + i[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = f[..., None] * n + i[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, S)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), min=1.0)
    h = (num / den[..., None]).reshape(b, 1, num_heads * hd)
    o = torch.sigmoid(x @ p.wo_gate)
    return ((h.to(x.dtype) * o) @ p.wo).to(x.dtype), S, n


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory block with recurrent mixing — strictly sequential)
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, d_model: int, dtype=torch.bfloat16) -> Params:
    return Params(
        wz=dense_init(gen, (d_model, d_model), dtype=dtype),
        wi=dense_init(gen, (d_model, d_model), dtype=_F32),
        wf=dense_init(gen, (d_model, d_model), dtype=_F32),
        wo_gate=dense_init(gen, (d_model, d_model), dtype=dtype),
        r=dense_init(gen, (d_model, d_model), dtype=dtype) * 0.1,
        wo=dense_init(gen, (d_model, d_model), dtype=dtype),
    )


def _slstm_cell(p, xt, c, n, h):
    """One sLSTM time step on ``xt`` [B, D]: returns (c, n, h). ``p`` is
    the block or a dict of its weights."""
    p = p if isinstance(p, dict) else dict(p.named_parameters())
    z = torch.tanh(xt @ p["wz"] + h @ p["r"])
    i = _input_gate(xt.to(_F32) @ p["wi"])
    f = torch.sigmoid(xt.to(_F32) @ p["wf"])
    c = f * c + i * z.to(_F32)
    n = f * n + i
    o = torch.sigmoid(xt @ p["wo_gate"]).to(_F32)
    return c, n, (o * c / torch.clamp(n, min=1.0)).to(xt.dtype)


def slstm_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Sequential sLSTM over time. x: [B, S, D]. Its recurrent mixing
    (``h @ r``) is dense, so on a mesh every "model" rank runs the whole
    block on its batch shard, the weights gathered (:func:`~.sharding.tp_region`
    with no head split)."""
    return tp_region(_slstm, x, tuple(p.parameters()), None, 1, names=tuple(
        n for n, _ in p.named_parameters()))


def _slstm(x, *weights, names: tuple[str, ...]) -> torch.Tensor:
    p = dict(zip(names, weights))
    b, s, d = x.shape
    if x.is_meta:       # the dry-run: five [B,D]x[D,D] products a step
        loop = [p[k] for k in ("wz", "r", "wi", "wf", "wo_gate")]
        hs = loop_on_meta([((b, s, d), x.dtype)], 10 * s * b * d * d, x, *loop)
        return (hs @ p["wo"]).to(x.dtype)
    c = torch.zeros((b, d), dtype=_F32, device=x.device)
    n = torch.zeros((b, d), dtype=_F32, device=x.device)
    h = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(s):
        c, n, h = _slstm_cell(p, x[:, t], c, n, h)
        hs.append(h)
    return (torch.stack(hs, dim=1) @ p["wo"]).to(x.dtype)


def slstm_decode_step(p: Params, x: torch.Tensor, c, n, h):
    """One-token sLSTM step; returns (out [B,1,D], c, n, h)."""
    c, n, h = _slstm_cell(p, x[:, 0], c, n, h)
    return (h @ p.wo).to(x.dtype)[:, None], c, n, h


# ---------------------------------------------------------------------------
# Mamba-style selective-SSM head (for Hymba parallel heads)
# ---------------------------------------------------------------------------


def init_mamba_head(gen: torch.Generator, d_model: int, d_inner: int, state: int,
                    dtype=torch.bfloat16) -> Params:
    p = dict(
        w_in=dense_init(gen, (d_model, d_inner), dtype=dtype),
        w_dt=dense_init(gen, (d_inner, 1), dtype=_F32),
        w_B=dense_init(gen, (d_inner, state), dtype=_F32),
        w_C=dense_init(gen, (d_inner, state), dtype=_F32),
    )
    p["a_log"] = zeros(gen, d_inner, state)              # A = -exp(a_log)
    p["w_out"] = dense_init(gen, (d_inner, d_model), dtype=dtype)
    return Params(**p)


def _mamba_inputs(p, u: torch.Tensor):
    p = p if isinstance(p, dict) else dict(p.named_parameters())
    uf = u.to(_F32)
    return F.softplus(uf @ p["w_dt"]), uf @ p["w_B"], uf @ p["w_C"], -torch.exp(p["a_log"])


def mamba_forward(p: Params, x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Selective SSM over time. x: [B, S, D] → [B, S, D].

    Simplified S6: per-channel diagonal state (size N), input-dependent
    (dt, B, C); recurrence h = exp(A·dt)·h + dt·B·u in f32, one step at a
    time. The reference scans chunks of ``chunk`` steps and cannot reshape
    a length that is not a multiple of it; the port refuses the same
    lengths.
    """
    b, s, _ = x.shape
    if s % min(chunk, s):
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    # dt, B and C contract over every channel, so on a mesh each "model"
    # rank runs the whole head on its batch shard, the weights gathered
    return tp_region(_mamba, x, tuple(p.parameters()), None, 1, names=tuple(
        n for n, _ in p.named_parameters()))


def _mamba(x, *weights, names: tuple[str, ...]) -> torch.Tensor:
    p = dict(zip(names, weights))
    b, s, _ = x.shape
    u = x @ p["w_in"]                                    # [B, S, di]
    dt, bmat, cmat, a = _mamba_inputs(p, u)
    if x.is_meta:       # the dry-run: one [B,di,N]·[B,N] contraction a step
        y = loop_on_meta([((b, s, u.shape[-1]), _F32)], 2 * s * b * a.numel(),
                         u, dt, bmat, cmat, a)
        return (y.to(x.dtype) * F.silu(u)) @ p["w_out"]
    h = torch.zeros((b, u.shape[-1], a.shape[1]), dtype=_F32, device=x.device)
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * u[:, t].to(_F32))[..., None] * bmat[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1)
    return (y.to(x.dtype) * F.silu(u)) @ p["w_out"]


def mamba_decode_step(p: Params, x: torch.Tensor, h: torch.Tensor):
    """One-token step. x: [B,1,D]; h: [B, di, N]."""
    u = x[:, 0] @ p.w_in
    dt, bmat, cmat, a = _mamba_inputs(p, u)
    h = torch.exp(dt[..., None] * a) * h + (dt * u.to(_F32))[..., None] * bmat[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, cmat)
    out = (y.to(x.dtype) * F.silu(u)) @ p.w_out
    return out[:, None], h
