"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=200064,
    mlp="swiglu", norm="rmsnorm", rope_theta=10_000.0,
    source="arXiv:2412.08905; hf",
)
