"""Whisper-large-v3 [arXiv:2212.04356]: enc-dec, conv frontend STUBBED
(input_specs provides precomputed frame embeddings). 32 enc + 32 dec layers.

Shape-cell semantics (DESIGN.md §Arch-applicability): seq_len maps to the
ENCODER frame axis (positional embedding extended past the published 1500);
the decoder runs within its published 448-token envelope. long_500k skipped
(full attention).
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="whisper_large_v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, encoder_layers=32, rope_kind="none",
    act="gelu", frontend_stub=True, max_decoder_len=448,
)
