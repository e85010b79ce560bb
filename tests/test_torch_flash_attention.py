"""The port's flash-attention forward (K12) against the JAX package's.

The same numpy inputs (from a seed) go to the reference's Pallas kernel in
interpret mode and its ``flash_attention_ref``, and to the port's plain
version and ``flash_attention_ref``, at every case of
``tests/test_flash_kernel.py``: float32 within rtol = atol = 2e-5 and
bfloat16 within 2e-2 (the reference test's figures; the sums run in
another order).  Also: the models' XLA-level ``_flash_gqa`` at that file's
shape, the reference's refusal of S or T that are not chunk multiples, and
that a CPU tensor never reaches the kernel wrapper.  The CUDA kernel itself
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
