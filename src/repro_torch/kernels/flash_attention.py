"""GQA flash-attention forward (K12), online softmax in float32.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention_fwd``
(``pallas_call`` at line 136, body ``_flash_kernel`` at line 49), with the
same layout and contract: ``q`` (B, S, H, hd), ``k`` and ``v`` (B, T, KV,
hd), result (B, S, H, hd) in ``q.dtype``.  Rows are flattened (B, KV, G)
with ``G = H // KV``, so q head ``h`` reads k/v head ``h // G`` (no repeat
of the grouped heads).  Logits are ``q . k / sqrt(hd)``; under ``causal``
a key at position ``kpos > qpos`` (both from 0) is masked to ``-1e30``,
and with a ``window`` W (under ``causal`` only, as the models'
``_flash_gqa``; ``None`` is none) so is a key at ``kpos <= qpos - W``:
query i sees keys ``i - W + 1 .. i``.
The softmax runs in float32 and the result is ``acc / max(l, 1e-30)``;
the products run in float32 (the float32 kernel: split TF32 on the tensor
cores, :func:`split_tf32`, within the float32 contract, rtol = atol =
2e-5), except in the bfloat16 kernel, which multiplies bfloat16 operands
on the tensor cores and rounds P to bfloat16 before P.V (within the
bfloat16 contract, rtol = atol = 2e-2 and a row-relative error of
:data:`BF16_ROW_REL_TOL`).  Chunks
are ``cq, ck = min(q_chunk, S), min(k_chunk, T)``; S and T must be
multiples of them, as the reference asserts.

:func:`flash_attention_fwd_torch` is the plain version: the reference's
online-softmax recurrence over (cq, ck) chunks, k chunks wholly past a q
chunk's last row skipped under ``causal``, and with a window those wholly
before its first row's window.  :func:`flash_attention_ref` is
the reference's full-logits oracle.  :func:`flash_attention_fwd_cuda`
wraps ``csrc/flash_attention.cu`` (float32 and bfloat16), and
:func:`flash_attention_fwd` picks by device.  Forward only, as the
reference: it has no backward and no ``ops`` entry point.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
#: Head widths the CUDA kernel is instantiated for (its register tile).
CUDA_HEAD_DIMS = (64, 128, 256)
#: The bfloat16 contract's second bound, beside rtol = atol = 2e-2: the
#: largest :func:`max_row_rel_err`.  A causal row at position n averages
#: about n / e keys, so its outputs are small (about sqrt(e / n)) and the
#: elementwise bound alone would pass a lost or misplaced k/v tile in a
#: long row; that tile moves the row by a share of its own norm.
BF16_ROW_REL_TOL = 0.05
#: The float32 kernel's tiles by head width: (q rows a block, keys a k/v
#: tile); a k or v tile is 4096 floats, and the ring has two slots.
TF32_TILES = {64: (128, 64), 128: (128, 32), 256: (64, 16)}
_CUDA_ENTRY = {torch.float32: "flash_attention_f32",
               torch.bfloat16: "flash_attention_bf16"}


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split TF32 as the float32 kernel splits its operands: ``hi`` is
    float32 ``x`` rounded to TF32 (10 mantissa bits; to nearest, ties away
    from zero: ``cvt.rna.tf32.f32``), ``lo`` is ``x - hi`` (exact) rounded
    the same way.  ``hi * y_hi + hi * y_lo + lo * y_hi`` then stands for
    ``x * y``: ``|x - hi - lo|`` is at most ``2**-21 * |x|``, or half the
    TF32 subnormal step (``2**-137``) where ``lo`` falls below the normal
    range.  For finite ``x`` below about ``2**128 * (1 - 2**-12)`` (larger
    ones round to inf).  The card does this in the kernel; this copy is
    for the tests and the CPU emulation of the kernel's arithmetic, not for
    the main path."""
    def rna(y):
        bits = y.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def _window(window, causal: bool) -> int:
    """The window as the kernels take it: 0 for none or when not causal."""
    if window is None or not causal:
        return 0
    if int(window) < 1:
        raise ValueError(f"window {window}: need at least one key")
    return int(window)


def _chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_chunk: int, k_chunk: int) -> tuple[int, int]:
    """Check the shapes and return ``(cq, ck)``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,S,H,hd) and k, v (B,T,KV,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    T = k.shape[1]
    cq, ck = min(q_chunk, S), min(k_chunk, T)
    if S % cq or T % ck:
        raise ValueError(f"pad S/T to chunk multiples first (S={S}, cq={cq}, "
                         f"T={T}, ck={ck})")
    return cq, ck


def flash_attention_fwd_torch(q, k, v, *, causal: bool = True,
                              q_chunk: int = 128, k_chunk: int = 128, window=None):
    """Plain PyTorch version of K12: the online-softmax recurrence.  A key
    before its row's window gets ``-inf``, as in the kernel (weight 0 while
    the row has seen no live key; the reference's ``-1e30`` gives the same
    result once the row's first live key rescales by 0)."""
    cq, ck = _chunks(q, k, v, q_chunk, k_chunk)
    w = _window(window, causal)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    # rows flattened (B, KV, G): [B, KV, G, S, hd] and [B, KV, T, hd]
    qf = q.to(f32).reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)
    kf = k.to(f32).permute(0, 2, 1, 3)
    vf = v.to(f32).permute(0, 2, 1, 3)
    out = torch.empty((B, KV, G, S, hd), dtype=f32, device=q.device)
    pos = torch.arange(max(cq, ck), device=q.device)
    for qi in range(S // cq):
        qc = qf[..., qi * cq:(qi + 1) * cq, :]
        m = torch.full((B, KV, G, cq), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((B, KV, G, cq), dtype=f32, device=q.device)
        acc = torch.zeros((B, KV, G, cq, hd), dtype=f32, device=q.device)
        for ki in range(T // ck):
            if causal and ki * ck > qi * cq + (cq - 1):
                continue
            if w and (ki + 1) * ck - 1 + w <= qi * cq:
                continue
            kc = kf[:, :, None, ki * ck:(ki + 1) * ck, :]
            vc = vf[:, :, None, ki * ck:(ki + 1) * ck, :]
            s = torch.matmul(qc, kc.transpose(-1, -2)) * scale
            if causal:
                kp, qp = (ki * ck + pos[:ck])[None, :], (qi * cq + pos[:cq])[:, None]
                s = torch.where(kp <= qp, s, NEG_INF)
                if w:
                    s = torch.where(kp + w > qp, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vc)
            m = m_new
        out[..., qi * cq:(qi + 1) * cq, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """Full-logits oracle (the reference's ``flash_attention_ref``, with
    the models' window mask): the softmax over every key in float32, GQA by
    the (B, KV, G) grouping."""
    w = _window(window, causal)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    f32 = torch.float32
    qg = q.to(f32).reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.to(f32)) / math.sqrt(hd)
    if causal:
        kp, qp = torch.arange(T, device=q.device)[None, :], torch.arange(
            S, device=q.device)[:, None]
        mask = kp <= qp
        if w:
            mask &= kp > qp - w
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.to(f32))
    return o.reshape(B, S, H, hd).to(q.dtype)


def max_row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ``||got - want|| / ||want||`` over the head width of any
    (b, s, h) row, in float32."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())


def flash_attention_fwd_cuda(q, k, v, *, causal: bool = True,
                             q_chunk: int = 128, k_chunk: int = 128, window=None):
    """Launch ``csrc/flash_attention.cu`` on the current stream: one block
    per (row of the (B, KV, G) flattening, q tile), walking its k tiles
    with the running max, denominator and accumulator on chip, both
    products on the tensor cores (``wgmma``), k and v tiles streamed by
    TMA through a ring, a q tile split between consumer warpgroups of 64
    rows that take turns.  float32: split TF32 (three TF32 products for
    each, :func:`split_tf32`), tiles :data:`TF32_TILES` (128 q rows and 64
    or 32 keys, 64 and 16 at hd 256), two ring slots, K split and V
    transposed and split in shared memory by the producer warpgroup.
    bfloat16: 128-row q tiles, k and v tiles of 128 keys (64 at hd 256), a
    ring of 3 slots (2 at hd 256), P rounded to bfloat16 before P.V.  The
    chunk arguments are checked as the reference checks them; the kernel's
    own tiles are its choice and change only the order of the sums.  With
    a window a block starts at the k tile that holds its first row's first
    key (T must be at least S there, so every row sees a key)."""
    from repro_torch.kernels import _build

    _chunks(q, k, v, q_chunk, k_chunk)
    w = _window(window, causal)
    if w and k.shape[1] < q.shape[1]:
        raise ValueError(f"window {w} with T = {k.shape[1]} < S = {q.shape[1]}: rows "
                         f"past T + W - 1 would see no key")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _CUDA_ENTRY or x.dtype != q.dtype or not x.is_cuda:
            raise ValueError(f"{name}: need float32 or bfloat16 CUDA tensors of "
                             f"one dtype, got {x.dtype} on {x.device}")
        if x.numel() >= 2**31:
            raise ValueError(f"{name}: {x.numel()} elements need int64 offsets")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if hd not in CUDA_HEAD_DIMS:
        raise ValueError(f"head width {hd} not in {CUDA_HEAD_DIMS}")
    if math.ceil(S / 64) >= 65536:
        raise ValueError(f"{S} query positions exceed the grid's y extent")
    # TMA reads from 16-byte aligned addresses only
    q, k, v = (x.contiguous() if x.data_ptr() % 16 == 0 else x.clone(
        memory_format=torch.contiguous_format) for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch = _build.kernel(_CUDA_ENTRY[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, T, H, KV, hd, int(causal), w, stream)
    flash_attention_fwd_cuda.launches += 1
    _build.check(err, _CUDA_ENTRY[q.dtype] + "_launch")
    return out


flash_attention_fwd_cuda.launches = 0


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        q_chunk: int = 128, k_chunk: int = 128, window=None):
    """GQA flash-attention forward, (B, S, H, hd) in ``q.dtype``: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    fn = flash_attention_fwd_cuda if q.is_cuda else flash_attention_fwd_torch
    return fn(q, k, v, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk, window=window)
