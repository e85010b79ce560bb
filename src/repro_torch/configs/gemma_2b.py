"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000,
    mlp="geglu", norm="rmsnorm", rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2403.08295; hf",
)
