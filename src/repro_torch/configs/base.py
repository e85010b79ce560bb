"""Architecture & shape configuration system.

One :class:`ArchConfig` per assigned architecture (exact published dims in
``configs/<id>.py``), plus the input-shape grid every architecture is
dry-run against.  ``reduce_for_smoke`` shrinks any config to a CPU-runnable
variant of the same family for the per-arch smoke tests.

A copy of ``repro.configs.base`` with one change: ``pdtype`` and ``cdtype``
return ``torch`` dtypes (the string fields ``param_dtype`` and
``compute_dtype`` are the same).  ``q_chunk`` and ``k_chunk`` are the loop
tiles of the plain attention recurrence (``models/layers.py:_flash_gqa``
on the CPU), not the flash-attention kernel's tiles: on the card K12
chooses its own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    mlp: str = "swiglu"              # swiglu | geglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # self-attn window (Mixtral SWA)
    # --- attention implementation (flash = chunked online softmax) ---
    attn_impl: str = "flash"         # flash | naive
    q_chunk: int = 1024
    k_chunk: int = 1024
    # --- rematerialization: checkpoint each layer group so only one
    # group's residuals are live during backward (62-80 layer models) ---
    remat_layers: bool = True
    remat_policy: str = "nothing"    # nothing | dots
    # --- MoE ---
    n_experts: int = 0
    topk_experts: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (RecurrentGemma) ---
    block_pattern: tuple[str, ...] = ("attn",)  # cycled; rglru | local | attn
    local_window: int = 2048
    conv_width: int = 4
    lru_dim: Optional[int] = None    # RG-LRU recurrence width (default d_model)
    # --- RWKV6 ---
    rwkv_head_dim: int = 64
    # --- encoder-decoder (Whisper) ---
    encoder_layers: int = 0          # > 0 => enc-dec
    encoder_seq: int = 1500          # Whisper: 30s audio -> 1500 frames
    # --- modality frontends (STUBS: input_specs provides embeddings) ---
    frontend: Optional[str] = None   # audio | vision
    n_prefix_embeds: int = 0         # precomputed frontend embeddings per sample
    # --- kinds & flags ---
    kind: str = "decoder"            # decoder | encdec | rwkv
    tie_embeddings: bool = False
    supports_long_context: bool = False   # sub-quadratic => run long_500k
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    source: str = ""                 # citation tag

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params_dense_equivalent(self) -> float:
        """Rough parameter count (for MODEL_FLOPS = 6*N*D roofline)."""
        d, f, hd = self.d_model, self.d_ff, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.mlp in ("swiglu", "geglu"):
            mlp_one = 3 * d * f
        else:
            mlp_one = 2 * d * f
        n_pat = len(self.block_pattern)
        attn_frac = sum(1 for b in self.block_pattern if b in ("attn", "local")) / n_pat
        rglru_frac = sum(1 for b in self.block_pattern if b == "rglru") / n_pat
        lru_d = self.lru_dim or self.d_model
        rglru_one = 2 * d * lru_d + lru_d * d + 3 * lru_d  # in/x-gate/out proj
        if self.kind == "rwkv":
            mix = 4 * d * d + d * d  # r,k,v,g,o
            layer = mix + mlp_one
        else:
            layer = attn_frac * attn + rglru_frac * rglru_one
            if self.is_moe:
                layer += self.n_experts * mlp_one  # total (active handled by caller)
            else:
                layer += mlp_one
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total_layers = self.n_layers + self.encoder_layers
        return total_layers * layer + emb

    def n_active_params(self) -> float:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.n_params_dense_equivalent()
        full = self.n_params_dense_equivalent()
        d, f = self.d_model, self.d_ff
        mlp_one = 3 * d * f if self.mlp in ("swiglu", "geglu") else 2 * d * f
        inactive = self.n_layers * (self.n_experts - self.topk_experts) * mlp_one
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable_shapes(cfg: ArchConfig) -> list[ShapeSpec]:
    """The (arch x shape) cells this arch runs.

    ``long_500k`` needs sub-quadratic attention -> skipped for pure
    full-attention archs (noted in DESIGN.md §4).
    """
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue
        out.append(s)
    return out


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Same-family reduced config: runnable forward/train step on CPU."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, max(2, len(cfg.block_pattern))),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=96,
        vocab=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        topk_experts=min(cfg.topk_experts, 2) if cfg.topk_experts else 0,
        # no-drop capacity so batch and incremental routing agree exactly
        # (capacity dropping is load-dependent: full-sequence and one-token
        # dispatch legitimately differ when experts overflow)
        capacity_factor=8.0 if cfg.n_experts else cfg.capacity_factor,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else None,
        local_window=min(cfg.local_window, 32),
        lru_dim=64 if cfg.lru_dim else None,
        rwkv_head_dim=16,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16),
        n_prefix_embeds=min(cfg.n_prefix_embeds, 4),
        q_chunk=8,
        k_chunk=8,
        param_dtype="float32",
        compute_dtype="float32",
    )


#: ``--smoke``'s head width on a CUDA device: the narrowest K12 takes
#: (``kernels/flash_attention.py:CUDA_HEAD_DIMS``); ``reduce_for_smoke``
#: gives 16, as the reference's does.
SMOKE_CUDA_HEAD_DIM = 64


def smoke_config(cfg: ArchConfig, device) -> tuple[ArchConfig, Optional[str]]:
    """``reduce_for_smoke(cfg)`` for the CLIs' and examples' ``--smoke``:
    on a CUDA device with ``head_dim`` :data:`SMOKE_CUDA_HEAD_DIM`, so K12
    runs at a width it takes, and a line saying so (``None`` elsewhere,
    where nothing changes)."""
    small = reduce_for_smoke(cfg)
    if torch.device(device).type != "cuda":
        return small, None
    return (dataclasses.replace(small, head_dim=SMOKE_CUDA_HEAD_DIM),
            f"--smoke on {device}: head_dim {small.hd} -> {SMOKE_CUDA_HEAD_DIM}, the "
            f"narrowest width K12 takes")
