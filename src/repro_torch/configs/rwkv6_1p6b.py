"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892; unverified].  Pure recurrence => runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65536,
    mlp="gelu", norm="layernorm",
    kind="rwkv", rwkv_head_dim=64,
    supports_long_context=True,
    source="arXiv:2404.05892; unverified",
)
