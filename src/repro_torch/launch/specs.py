"""Shape-only stand-ins for every (arch × shape) cell, the dry-run's inputs
(port of ``repro.launch.specs``): tensors on the ``meta`` device, where the
reference gives ``ShapeDtypeStruct``\\ s. Nothing is allocated.

Cell semantics:
  train_4k    → ``train_step``  : tokens/labels [GB, S] (stub: embeds)
  prefill_32k → ``prefill_step``: forward over the full sequence
  decode_32k  → ``serve_step``  : ONE new token against a seq_len KV cache
  long_500k   → ``serve_step``  : as above at 524288 (sub-quadratic archs only)
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import SHAPES, ArchConfig, get_config
from repro_torch.models.layers import Params
from repro_torch.models.transformer import init_decode_state, init_model

__all__ = ["input_specs", "decode_state_shapes", "param_shapes", "cell_is_supported",
           "skip_reason"]


def cell_is_supported(cfg: ArchConfig, shape_name: str) -> bool:
    return skip_reason(cfg, shape_name) is None


def skip_reason(cfg: ArchConfig, shape_name: str) -> str | None:
    if shape_name == "long_500k" and not cfg.subquadratic:
        return ("full attention: 524k-token KV has no sub-quadratic path in the "
                "published architecture (DESIGN.md §Arch-applicability)")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch, shape_name: str) -> dict:
    """The cell's inputs as meta tensors: the batch for train and prefill;
    ``tokens``, ``pos`` (an int) and ``state`` for decode."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    seq, gb, kind = SHAPES[shape_name]

    if kind in ("train", "prefill"):
        batch = {}
        if cfg.encoder_layers:  # whisper: encoder frames + decoder text
            batch["embeds"] = _meta((gb, seq, cfg.d_model), torch.bfloat16)
            batch["dec_tokens"] = _meta((gb, cfg.max_decoder_len), torch.int32)
            if kind == "train":
                batch["labels"] = _meta((gb, cfg.max_decoder_len), torch.int32)
        elif cfg.frontend_stub:  # vlm: patch/frame embeddings
            batch["embeds"] = _meta((gb, seq, cfg.d_model), torch.bfloat16)
            if kind == "train":
                batch["labels"] = _meta((gb, seq), torch.int32)
        else:
            batch["tokens"] = _meta((gb, seq), torch.int32)
            if kind == "train":
                batch["labels"] = _meta((gb, seq), torch.int32)
        return batch

    # decode: one token + cache/state
    out = {
        "tokens": _meta((gb, 1), torch.int32),
        "pos": seq - 1,
        "state": decode_state_shapes(cfg, gb, seq),
    }
    if cfg.encoder_layers:
        # cross-attention context from the encoder (its own envelope)
        out["enc_out"] = _meta((gb, 1500, cfg.d_model), torch.bfloat16)
    return out


def decode_state_shapes(cfg: ArchConfig, batch: int, kv_len: int) -> dict:
    """``init_decode_state``'s tensors on the meta device (no allocation)."""
    return init_decode_state(cfg, batch, kv_len, dtype=torch.bfloat16, device="meta")


def param_shapes(cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    """The model ``init_model`` builds, every parameter on the meta device:
    the real names and shapes. ``init_model`` draws from a
    ``torch.Generator``, which the meta device has not, so it runs on the
    CPU under ``FakeTensorMode`` (nothing allocated) and the fake
    parameters are swapped for meta ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_model(cfg, 0, dtype=dtype, device="cpu")
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = params.get_submodule(owner) if owner else params
        module.register_parameter(leaf, torch.nn.Parameter(
            _meta(p.shape, p.dtype), requires_grad=p.requires_grad))
    return params
