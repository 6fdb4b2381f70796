"""xLSTM-1.3B [arXiv:2405.04517]: sLSTM + mLSTM blocks (recurrent, O(1) state).

We interleave (mLSTM, sLSTM) in super-layers (1:1; the paper's 1.3B uses a
mLSTM-dominant mix — noted in DESIGN.md §Arch-applicability). num_layers=24
SUPER-layers = 48 blocks (the published 48L). d_ff=0: blocks carry their own
projections. Sub-quadratic → runs long_500k.
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="xlstm_1_3b", family="ssm",
    num_layers=24, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, rope_kind="none", subquadratic=True,
)
