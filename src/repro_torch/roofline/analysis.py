"""Roofline terms on one H100 (the port's counterpart of
``repro.roofline.analysis``).

Three terms, in seconds, as in the reference::

    compute    = FLOPs / (chips * peak FLOP/s of the operations' kind)
    memory     = HBM bytes / (chips * HBM bytes/s)
    collective = link bytes / NVLink bytes/s   (0 on one card)

The inputs come from :func:`repro_torch.roofline.op_cost.count_cost` (the
counterpart of the reference's compiled-HLO cost) or, for one kernel, from
the launch contract's ``work`` (:func:`kernel_bound`).  The rates are the
NVIDIA H100 SXM5 datasheet's, dense (no sparsity):

- HBM3: 3.35e12 bytes/s;
- bfloat16 tensor cores: 989e12 FLOP/s;
- TF32 tensor cores: 495e12 FLOP/s (the port's split-TF32 float32 kernel
  does three TF32 products a product, so its peak is a third of that);
- CUDA cores, float32 and 32-bit integer: 67e12 operations/s (the figure
  the kernel bounds of the port's record use for integer work);
- NVLink 4: 450e9 bytes/s each way, for the collective term (0 on one
  card; a dry-run cell's link bytes over it).

What a kernel's data needs (postings probed, packed blocks decoded,
attention keys kept) is counted beside the kernels, in
:mod:`repro_torch.kernels.work`; this module only prices it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels import registry

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
FP32_FLOPS_PER_S = 67e12
INT32_OPS_PER_S = 67e12
NVLINK_BYTES_PER_S = 450e9

#: Peak operations a second by the kind a ``Work`` names.
PEAK_BY_UNIT = {
    "int32": INT32_OPS_PER_S,
    "float32": FP32_FLOPS_PER_S,
    "tf32x3": TF32_FLOPS_PER_S / 3,
    "bf16": BF16_FLOPS_PER_S,
}


@dataclasses.dataclass
class Roofline:
    flops: float                 # counted FLOPs (matmul family and convolutions)
    hbm_bytes: float             # bytes read and written
    link_bytes: float            # per-device collective bytes
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_from_cost(cost, chips: int = 1, *, model_flops: float = 0.0,
                       peak: float = BF16_FLOPS_PER_S) -> Roofline:
    """The three terms of a counted cost (``op_cost.Cost``) on ``chips``
    cards, its FLOPs at ``peak``."""
    chips = max(int(chips), 1)
    compute_s = cost.flops / (chips * peak)
    memory_s = cost.hbm_bytes / (chips * HBM_BYTES_PER_S)
    collective_s = cost.link_bytes / NVLINK_BYTES_PER_S if chips > 1 else 0.0
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return Roofline(
        flops=cost.flops, hbm_bytes=cost.hbm_bytes, link_bytes=cost.link_bytes,
        chips=chips, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_ratio=(model_flops / (cost.flops * chips)) if cost.flops else 0.0,
    )


def link_factor(kind: str, n: int) -> float:
    """Ring-algorithm bytes on the busiest link per operand byte of a
    collective over n ranks (the reference's ``_link_factor``)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "all-gather":       # operand = local shard
        return float(n - 1)
    if kind in ("reduce-scatter", "all-to-all"):   # operand = full array
        return (n - 1) / n
    return 1.0


def roofline_per_device(cost, chips: int, *, model_flops: float = 0.0,
                        peak: float = BF16_FLOPS_PER_S) -> Roofline:
    """The three terms of one rank's counted cost (a dry-run cell's:
    per-device FLOPs, HBM and link bytes, as the reference's post-SPMD
    module) on an H100 of an NVLink mesh of ``chips`` cards."""
    compute_s = cost.flops / peak
    memory_s = cost.hbm_bytes / HBM_BYTES_PER_S
    collective_s = cost.link_bytes / NVLINK_BYTES_PER_S
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return Roofline(
        flops=cost.flops, hbm_bytes=cost.hbm_bytes, link_bytes=cost.link_bytes,
        chips=chips, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_ratio=(model_flops / (cost.flops * chips)) if cost.flops else 0.0,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); D = tokens/step."""
    n = cfg.n_active_params()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def lm_param_count(cfg) -> int:
    """A model's parameter count from its config's shapes alone: norms (a
    scale, and a bias for a layernorm), attention or RG-LRU mixers with an
    MLP or an MoE FFN (its float32 router) by block kind, RWKV6's time and
    channel mix, an encoder-decoder's cross attention and its norm in every
    decoder layer and its encoder layers and final norm, the embedding, the
    head unless tied, the final norm."""
    d, R = cfg.d_model, cfg.lru_dim or cfg.d_model
    norm = (2 if cfg.norm == "layernorm" else 1) * d
    mlp = (3 if cfg.mlp in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    ffn = cfg.n_experts * mlp + d * cfg.n_experts if cfg.is_moe else mlp
    attn = 2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
    # RWKV6: mu (5 rows), w0, u, ln_scale, r k v g o, the rank-64 LoRA; the
    # channel mix's mu (2 rows), wk, wv, wr
    rwkv = 8 * d + 5 * d * d + 2 * 64 * d + 2 * d + 2 * d * cfg.d_ff + d * d
    mixer = {"attn": attn + ffn, "local": attn + ffn,
             "rglru": 3 * d * R + (cfg.conv_width + 6) * R + ffn, "rwkv": rwkv}
    pat = ("rwkv",) if cfg.kind == "rwkv" else cfg.block_pattern
    cross = attn + norm if cfg.kind == "encdec" else 0
    layers = sum(mixer[pat[i % len(pat)]] + 2 * norm + cross for i in range(cfg.n_layers))
    encoder = cfg.encoder_layers * (attn + ffn + 2 * norm) + (norm if cfg.encoder_layers
                                                              else 0)
    return layers + encoder + cfg.vocab * d * (1 if cfg.tie_embeddings else 2) + norm


def bound_ms(n_bytes: int, n_ops: int, unit: str = "int32") -> tuple[float, str]:
    """The least milliseconds ``n_bytes`` of HBM traffic and ``n_ops``
    operations of kind ``unit`` take on one H100, and which of the two
    bounds it (``"bytes"`` or ``"operations"``)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_BY_UNIT[unit]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_bound(entry: str, *args, **kwargs) -> tuple[float, str, object]:
    """``(ms, bound_by, work)`` of launch-contract entry ``entry`` on its
    wrapper's arguments: the registry's ``work`` through
    :func:`bound_ms`."""
    w = registry.work(entry, *args, **kwargs)
    ms, by = bound_ms(w.bytes, w.ops, w.unit)
    return ms, by, w
