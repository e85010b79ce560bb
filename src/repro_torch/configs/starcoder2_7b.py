"""starcoder2-7b [dense] — GQA, RoPE, LayerNorm + GELU MLP
[arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152,
    mlp="gelu", norm="layernorm", rope_theta=100_000.0,
    source="arXiv:2402.19173; hf",
)
