"""DeepSeek-Coder-33B [arXiv:2401.14196; hf]: llama-arch, GQA kv=8."""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_coder_33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32256,
)
