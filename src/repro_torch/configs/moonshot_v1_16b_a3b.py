"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840,
    mlp="swiglu", norm="rmsnorm", rope_theta=50_000.0,
    n_experts=64, topk_experts=6,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
