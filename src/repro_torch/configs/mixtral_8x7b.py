"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    mlp="swiglu", norm="rmsnorm", rope_theta=1_000_000.0,
    sliding_window=4096,
    n_experts=8, topk_experts=2,
    source="arXiv:2401.04088; hf",
)
