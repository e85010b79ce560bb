"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427; hf].  26 layers = 8 full (rglru,rglru,local) groups + a
2-layer remainder.  Sub-quadratic => runs the long_500k cell."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000,
    mlp="geglu", norm="rmsnorm", rope_theta=10_000.0,
    block_pattern=("rglru", "rglru", "local"), local_window=2048,
    conv_width=4, lru_dim=2560,
    tie_embeddings=True, supports_long_context=True,
    source="arXiv:2402.19427; hf",
)
