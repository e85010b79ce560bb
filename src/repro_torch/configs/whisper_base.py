"""whisper-base [audio] — enc-dec, conv frontend STUB
[arXiv:2212.04356; unverified].

Fidelity notes: the conv1d+mel frontend is a stub (input_specs() supplies
precomputed 1500-frame embeddings, i.e. 30s of audio).  Whisper's learned
absolute positions are replaced by sinusoidal embeddings so the assigned
32k decode shapes are well-defined (the published decoder caps at 448
positions); noted in DESIGN.md §4.  The decode_* / prefill_* cells lower
the decoder with encoder output as cross-attention memory.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865,
    mlp="gelu", norm="layernorm",
    kind="encdec", encoder_layers=6, encoder_seq=1500,
    frontend="audio",
    source="arXiv:2212.04356; unverified",
)
