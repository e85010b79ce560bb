"""internvl2-76b [vlm] — InternViT + InternLM2 backbone
[arXiv:2404.16821; unverified].

The ViT frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (n_prefix_embeds per sample) that are
prepended to the token stream; the backbone below is the language model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256,
    mlp="swiglu", norm="rmsnorm", rope_theta=1_000_000.0,
    frontend="vision", n_prefix_embeds=256,
    source="arXiv:2404.16821; unverified",
)
