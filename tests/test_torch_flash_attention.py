"""The port's flash-attention forward (K12) against the JAX package's.

The same numpy inputs (from a seed) go to the reference's Pallas kernel in
interpret mode and its ``flash_attention_ref``, and to the port's plain
version and ``flash_attention_ref``, at every case of
``tests/test_flash_kernel.py``: float32 within rtol = atol = 2e-5 and
bfloat16 within 2e-2 (the reference test's figures; the sums run in
another order).  Also: the models' XLA-level ``_flash_gqa`` at that file's
shape, the CUDA bf16 kernel's rounding of P (emulated here) within the
bf16 tolerance of the reference's oracle and within its row-relative
bound, which a lost or misplaced k/v tile in a long row would break, the
reference's refusal of S or
T that are not chunk multiples, and that a CPU tensor never reaches the
kernel wrapper.  Windows: the plain version and ``flash_attention_ref``
with a ``window`` against the reference's ``_flash_gqa(window=)`` within
2e-5, with S past W, W under a chunk and a chunk multiple, and W >= S
(then equal to no window); a window changes nothing off ``causal``; the
CUDA wrapper refuses a window under 1 or with T < S before it builds.  The CUDA kernel itself
is held against the plain version on the card by ``chip_smoke.py``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention as ref_fa
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as pt_fa

ROOT = Path(__file__).resolve().parents[1]
CASES = [
    (1, 256, 256, 4, 4, 64, 128, 128),   # MHA, exact chunks
    (2, 256, 256, 4, 2, 64, 128, 128),   # GQA g=2
    (1, 256, 256, 4, 1, 64, 128, 128),   # MQA
    (1, 512, 512, 2, 2, 128, 128, 256),  # rectangular chunks
    (1, 128, 384, 2, 2, 64, 128, 128),   # cross-ish: T > S
]
TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, s, t, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("causal", [True, False])
def test_plain_and_ref_match_the_reference(case, causal):
    b, s, t, h, kv, hd, cq, ck = case
    q, k, v = _inputs(sum(case) + causal, b, s, t, h, kv, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = ref_fa.flash_attention_fwd(jq, jk, jv, causal=causal, q_chunk=cq,
                                      k_chunk=ck, interpret=True)
    want_ref = ref_fa.flash_attention_ref(jq, jk, jv, causal=causal)
    got = pt_fa.flash_attention_fwd(tq, tk, tv, causal=causal, q_chunk=cq,
                                    k_chunk=ck)
    got_ref = pt_fa.flash_attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, hd)
    tol = TOL[np.float32]
    _close(got.numpy(), want, tol)
    _close(got.numpy(), want_ref, tol)
    _close(got_ref.numpy(), want_ref, tol)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_the_reference(causal):
    q, k, v = _inputs(11, 1, 256, 256, 2, 2, 64)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = ref_fa.flash_attention_fwd(jq, jk, jv, causal=causal, interpret=True)
    want_ref = ref_fa.flash_attention_ref(jq, jk, jv, causal=causal)
    got = pt_fa.flash_attention_fwd(tq, tk, tv, causal=causal)
    got_ref = pt_fa.flash_attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got_ref.dtype == torch.bfloat16
    tol = TOL["bfloat16"]
    _close(got.float().numpy(), want, tol)
    _close(got_ref.float().numpy(), want_ref, tol)
    _close(got.float().numpy(), got_ref.float().numpy(), tol)


def _bf16_p_recurrence(q, k, v, *, causal, q_chunk, k_chunk):
    """The plain online-softmax recurrence with the bf16 kernel's rounding:
    P rounded to bfloat16 before P.V, ``l`` summed from the unrounded P,
    everything else in float32 (the tensor cores sum bf16 products in
    float32)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G, f32 = H // KV, torch.float32
    qf = q.to(f32).reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (x.to(f32).permute(0, 2, 1, 3)[:, :, None] for x in (k, v))
    out = torch.empty((B, KV, G, S, hd), dtype=f32)
    for q0 in range(0, S, q_chunk):
        qc = qf[..., q0:q0 + q_chunk, :]
        qpos = torch.arange(q0, q0 + q_chunk)
        m = torch.full(qc.shape[:-1], pt_fa.NEG_INF)
        l = torch.zeros(qc.shape[:-1])
        acc = torch.zeros(qc.shape)
        for k0 in range(0, T, k_chunk):
            if causal and k0 > q0 + q_chunk - 1:
                continue
            s = qc @ kf[..., k0:k0 + k_chunk, :].transpose(-1, -2) / np.sqrt(hd)
            if causal:
                live = torch.arange(k0, k0 + k_chunk)[None, :] <= qpos[:, None]
                s = torch.where(live, s, pt_fa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = p.to(torch.bfloat16).to(f32) @ vf[..., k0:k0 + k_chunk, :]
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[..., q0:q0 + q_chunk, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(torch.bfloat16)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("h,kv", [(6, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_rounded_p_stays_within_the_bf16_tolerance(hd, h, kv, causal):
    """The CUDA bf16 kernel's arithmetic on the CPU: P rounded to bfloat16
    before P.V, at its own tiles (128 q rows, 128 keys, 64 at hd 256),
    within rtol = atol = 2e-2 of the reference's full-logits oracle."""
    s, t = 256, 384
    q, k, v = (x.astype(np.float32) for x in _inputs(hd + h + causal, 1, s, t, h, kv, hd))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = ref_fa.flash_attention_ref(jq, jk, jv, causal=causal)
    got = _bf16_p_recurrence(tq, tk, tv, causal=causal, q_chunk=128,
                             k_chunk=128 if hd <= 128 else 64)
    assert got.dtype == torch.bfloat16 and got.shape == (1, s, h, hd)
    _close(got.float().numpy(), want, TOL["bfloat16"])
    want_t = torch.from_numpy(np.asarray(want, np.float32))
    assert pt_fa.max_row_rel_err(got, want_t) < pt_fa.BF16_ROW_REL_TOL
    # and against the port's plain version, which keeps P in float32
    plain = pt_fa.flash_attention_fwd(tq, tk, tv, causal=causal)
    _close(got.float().numpy(), plain.float().numpy(), TOL["bfloat16"])
    assert pt_fa.max_row_rel_err(got, plain) < pt_fa.BF16_ROW_REL_TOL


def _last_rows(q, k, v, rows, *, round_p=False, dropped=None):
    """Causal attention (S = T) of the last ``rows`` query rows, full logits
    in float32; keys in the slice ``dropped`` are left out, and with
    ``round_p`` P is rounded to bfloat16 before P.V (``l`` unrounded)."""
    S, hd, G = q.shape[1], q.shape[3], q.shape[2] // k.shape[2]
    qf = q[:, S - rows:].float().transpose(1, 2)
    kf, vf = (x.float().repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))
    s = qf @ kf.transpose(-1, -2) / np.sqrt(hd)
    s = s.masked_fill(torch.arange(S)[None, :] > torch.arange(S - rows, S)[:, None],
                      pt_fa.NEG_INF)
    if dropped is not None:
        s[..., dropped] = -torch.inf
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if round_p:
        p = p.to(torch.bfloat16).float()
    return ((p @ vf) / l).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["dropped", "wrong slot"])
@pytest.mark.parametrize("hd,bk,stages", [(128, 128, 3), (256, 64, 2)])
@pytest.mark.parametrize("s", [2048, 4096])
def test_row_relative_bound_catches_a_lost_kv_tile(fault, hd, bk, stages, s):
    """The bf16 kernel's row-relative bound tells a ring fault from rounding
    in the long causal rows, where rtol = atol = 2e-2 is about as large as
    a typical output: the last q tile with one k/v tile of the middle of
    the row left out, or with V read from the slot's previous tile, is past
    ``BF16_ROW_REL_TOL``; the kernel's rounding of P is well inside it."""
    rows, j = 128, s // bk // 2
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(s + hd, 1, s, s, 2, 1, hd))
    want = _last_rows(q, k, v, rows)
    assert pt_fa.max_row_rel_err(_last_rows(q, k, v, rows, round_p=True), want) \
        < pt_fa.BF16_ROW_REL_TOL / 4
    if fault == "dropped":
        bad = _last_rows(q, k, v, rows, dropped=slice(j * bk, (j + 1) * bk))
    else:
        v2 = v.clone()
        v2[:, j * bk:(j + 1) * bk] = v[:, (j - stages) * bk:(j - stages + 1) * bk]
        bad = _last_rows(q, k, v2, rows)
    assert pt_fa.max_row_rel_err(bad, want) > 2 * pt_fa.BF16_ROW_REL_TOL


def test_matches_the_models_flash_path():
    """The plain version equals the XLA-level ``_flash_gqa`` the models use
    (causal, no window, every key live)."""
    from repro.models.layers import _flash_gqa

    b, s, h, kv, hd = 1, 256, 4, 2, 64
    q, k, v = _inputs(7, b, s, s, h, kv, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = _flash_gqa(
        jq.reshape(b, s, kv, h // kv, hd), jk, jv,
        jnp.zeros((b,), jnp.int32), jnp.zeros((b,), jnp.int32),
        jnp.full((b,), s, jnp.int32),
        causal=True, window=None, scale=1.0 / np.sqrt(hd),
        q_chunk=128, k_chunk=128,
    ).reshape(b, s, h, hd)
    got = pt_fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    _close(got.numpy(), want, TOL[np.float32])


WINDOW_CASES = {
    # id: (B, S, H, KV, hd, window, chunk)
    "S-past-W": (2, 256, 4, 2, 64, 100, 64),
    "W-under-a-chunk": (1, 256, 6, 2, 32, 5, 64),
    "W-a-chunk-multiple": (1, 256, 2, 1, 32, 128, 64),
    "W-at-least-S": (1, 192, 4, 1, 64, 300, 64),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES), ids=list(WINDOW_CASES))
def test_window_matches_the_models_flash_gqa(case):
    from repro.models.layers import _flash_gqa

    b, s, h, kv, hd, w, ch = WINDOW_CASES[case]
    q, k, v = _inputs(len(case), b, s, s, h, kv, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    zero = jnp.zeros((b,), jnp.int32)
    want = _flash_gqa(jq.reshape(b, s, kv, h // kv, hd), jk, jv, zero, zero,
                      jnp.full((b,), s, jnp.int32), causal=True, window=w,
                      scale=1.0 / np.sqrt(hd), q_chunk=ch, k_chunk=ch).reshape(b, s, h, hd)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = pt_fa.flash_attention_fwd(tq, tk, tv, q_chunk=ch, k_chunk=ch, window=w)
    _close(got.numpy(), want, TOL[np.float32])
    _close(pt_fa.flash_attention_ref(tq, tk, tv, window=w).numpy(), want, TOL[np.float32])
    if w >= s:
        assert torch.equal(got, pt_fa.flash_attention_fwd(tq, tk, tv, q_chunk=ch,
                                                          k_chunk=ch))
    else:
        # the window masks: no window is another result
        assert not np.allclose(pt_fa.flash_attention_ref(tq, tk, tv).numpy(), want,
                               atol=1e-3)
    # off causal the window is ignored, as in the reference
    assert torch.equal(pt_fa.flash_attention_fwd(tq, tk, tv, causal=False, q_chunk=ch,
                                                 k_chunk=ch, window=w),
                       pt_fa.flash_attention_fwd(tq, tk, tv, causal=False, q_chunk=ch,
                                                 k_chunk=ch))


def test_cuda_wrapper_refuses_windows_it_cannot_take(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a refused call reached the kernel build")

    monkeypatch.setattr(_build, "kernel", no_build)
    q, k, v = map(torch.from_numpy, _inputs(5, 1, 128, 64, 2, 1, 64))
    with pytest.raises(ValueError, match="T = 64 < S = 128"):
        pt_fa.flash_attention_fwd_cuda(q, k, v, window=32)
    with pytest.raises(ValueError, match="at least one key"):
        pt_fa.flash_attention_fwd_cuda(q, k[:, :64].repeat(1, 2, 1, 1),
                                       v[:, :64].repeat(1, 2, 1, 1), window=0)


@pytest.mark.parametrize("s,t,cq,ck,raises", [
    (200, 256, 128, 128, True),    # S not a multiple of its chunk
    (256, 200, 128, 128, True),    # T not a multiple of its chunk
    (256, 384, 128, 256, True),    # T = 384 against a 256 chunk
    (100, 96, 128, 128, False),    # chunks clip to S and T
    (192, 256, 64, 256, False),
])
def test_refuses_what_the_reference_refuses(s, t, cq, ck, raises):
    q, k, v = _inputs(3, 1, s, t, 2, 1, 32)
    args = dict(causal=False, q_chunk=cq, k_chunk=ck)
    if raises:
        with pytest.raises(AssertionError):
            ref_fa.flash_attention_fwd(*map(jnp.asarray, (q, k, v)),
                                       interpret=True, **args)
        with pytest.raises(ValueError, match="chunk multiples"):
            pt_fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), **args)
    else:
        want = ref_fa.flash_attention_fwd(*map(jnp.asarray, (q, k, v)),
                                          interpret=True, **args)
        got = pt_fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), **args)
        _close(got.numpy(), want, TOL[np.float32])


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(_build, "kernel", no_build)
    monkeypatch.setattr(pt_fa.flash_attention_fwd_cuda, "launches", 0)
    q, k, v = map(torch.from_numpy, _inputs(5, 1, 128, 128, 2, 1, 64))
    pt_fa.flash_attention_fwd(q, k, v)
    pt_fa.flash_attention_fwd(q.to(torch.bfloat16), k.to(torch.bfloat16),
                              v.to(torch.bfloat16), causal=False)
    assert pt_fa.flash_attention_fwd_cuda.launches == 0
    # the CUDA wrapper refuses a CPU tensor instead of falling back
    with pytest.raises(ValueError, match="CUDA"):
        pt_fa.flash_attention_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        pt_fa.flash_attention_fwd_cuda(q.double(), k.double(), v.double())


def test_imports_and_runs_with_no_card_and_no_nvcc(tmp_path):
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "import torch",
        "from repro_torch.kernels import flash_attention as fa",
        "assert not torch.cuda.is_available()",
        "q = torch.ones(1, 64, 2, 32); k = v = torch.ones(1, 64, 1, 32)",
        "out = fa.flash_attention_fwd(q, k, v)",
        "assert torch.allclose(out, torch.ones_like(out))",
        "assert fa.flash_attention_fwd_cuda.launches == 0",
        "print('OK')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"
