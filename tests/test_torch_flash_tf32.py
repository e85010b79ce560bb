"""The float32 flash-attention kernel's arithmetic (K12, split TF32) on the CPU.

The CUDA float32 kernel multiplies on the tensor cores in TF32, three
products for each: every float32 operand x is split into ``hi`` (x rounded
to TF32) and ``lo`` (x - hi rounded to TF32), and x . y is taken as
hi.hi + hi.lo + lo.hi.  The kernel cannot run here, so this file holds its
arithmetic: :func:`repro_torch.kernels.flash_attention.split_tf32` against
the TF32 rounding it stands for (hypothesis over finite float32 values,
subnormals included), and the online-softmax recurrence at the kernel's own
tiles (``TF32_TILES``) and exponent (``exp2`` of logits scaled by
``scale * log2(e)``), with Q, K, P and V split as the kernel splits them,
within the float32 contract (rtol = atol = 2e-5) of the reference's
full-logits oracle and its Pallas kernel in interpret mode, on the same
numpy inputs.  The same recurrence with hi.hi alone is past 2e-5, so the
three products are needed and the comparison can fail.  The kernel itself
is held against the plain version on the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.kernels import flash_attention as ref_fa
from repro_torch.kernels import flash_attention as pt_fa

TOL = 2e-5
LOW13 = 0x1FFF


def _bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


finite_f32 = st.floats(min_value=-2.0**100, max_value=2.0**100, width=32,
                       allow_nan=False, allow_infinity=False, allow_subnormal=True)


@settings(max_examples=400, deadline=None)
@given(st.lists(finite_f32, min_size=1, max_size=64))
def test_split_tf32_hi_is_tf32_rounded_to_nearest_ties_away(xs):
    x = np.array(xs, np.float32)
    hi, lo = (t.numpy() for t in pt_fa.split_tf32(torch.from_numpy(x)))
    for y in (hi, lo):
        assert not (_bits(y) & LOW13).any()          # TF32: low 13 bits zero
    # the two TF32 values around x: its bits truncated, and one TF32 step
    # further from zero
    u = _bits(x)
    down = (u & ~np.uint32(LOW13)).view(np.float32).astype(np.float64)
    up = ((u & ~np.uint32(LOW13)) + np.uint32(0x2000)).view(np.float32).astype(np.float64)
    xd, hd = x.astype(np.float64), hi.astype(np.float64)
    tie = (u & LOW13) == 0x1000
    nearest = np.where(np.abs(xd - down) < np.abs(up - xd), down, up)
    want = np.where(tie, up, nearest)
    want = np.where((u & LOW13) == 0, xd, want)
    np.testing.assert_array_equal(hd, want)
    # ties go away from zero
    assert (np.abs(hd[tie]) > np.abs(xd[tie])).all()


@settings(max_examples=400, deadline=None)
@given(st.lists(finite_f32, min_size=1, max_size=64))
def test_split_tf32_hi_plus_lo_holds_x_to_2_pow_minus_21(xs):
    x = np.array(xs, np.float32)
    hi, lo = (t.numpy().astype(np.float64) for t in pt_fa.split_tf32(torch.from_numpy(x)))
    xd = x.astype(np.float64)
    err = np.abs(xd - hi - lo)
    # relative 2^-21, or half the TF32 subnormal step where lo is subnormal
    assert (err <= np.maximum(2.0**-21 * np.abs(xd), 2.0**-137)).all()
    normal = np.abs(xd) >= 2.0**-104        # lo stays a normal number
    assert (err[normal] <= 2.0**-21 * np.abs(xd[normal])).all()


def test_split_tf32_edges():
    x = torch.tensor([0.0, -0.0, 1.0, 1 + 2**-11, -(1 + 2**-11), 1 + 2**-11 + 2**-23,
                      2.0**-126, 2.0**-149, 2.0**100, -3.0e-39], dtype=torch.float32)
    hi, lo = pt_fa.split_tf32(x)
    assert hi[3] == 1 + 2**-10 and lo[3] == -2**-11            # a tie, away from zero
    assert hi[4] == -(1 + 2**-10) and lo[4] == 2**-11
    assert hi[0] == 0 and lo[0] == 0 and torch.signbit(hi[1])
    assert hi[8] == 2.0**100 and lo[8] == 0
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= torch.clamp(2.0**-21 * x.double().abs(), min=2.0**-137)).all())


def _inputs(seed, b, s, t, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32))


def _split_recurrence(q, k, v, *, causal, three=True):
    """The CUDA float32 kernel's arithmetic: q tiles of BQ rows, k/v tiles
    of BK keys (``TF32_TILES``), k tiles past a q tile's last row skipped
    under causal; S = Qh.Kh + Qh.Kl + Ql.Kh, logits scaled by the float32
    ``scale * log2(e)``, masked to -1e30 after scaling, P = exp2(x - m),
    ``l`` summed from the unsplit P, O += Ph.Vh + Ph.Vl + Pl.Vh.  With
    ``three`` False, hi.hi alone for both products.  TF32 products are
    exact in float32, so a float32 matmul of split operands is the tensor
    cores' sum up to its order."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    bq, bk = pt_fa.TF32_TILES[hd]
    G = H // KV
    qf = q.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (x.permute(0, 2, 1, 3)[:, :, None] for x in (k, v))
    (qh, ql), (kh, kl), (vh, vl) = (pt_fa.split_tf32(x) for x in (qf, kf, vf))
    scale_log2 = float(np.float32(1.0 / np.sqrt(hd)) * np.float32(1.4426950408889634))
    out = torch.empty((B, KV, G, S, hd), dtype=torch.float32)
    for q0 in range(0, S, bq):
        rows = slice(q0, min(q0 + bq, S))
        qpos = torch.arange(q0, rows.stop)
        n_kt = -(-T // bk)
        if causal:
            n_kt = min(n_kt, (q0 + bq - 1) // bk + 1)
        m = torch.full(qpos.shape, pt_fa.NEG_INF).expand(B, KV, G, -1)
        l = torch.zeros(m.shape)
        acc = torch.zeros((B, KV, G, qpos.numel(), hd))
        a_h, a_l = qh[..., rows, :], ql[..., rows, :]
        for k0 in range(0, n_kt * bk, bk):
            keys = slice(k0, min(k0 + bk, T))
            b_h, b_l = kh[..., keys, :].transpose(-1, -2), kl[..., keys, :].transpose(-1, -2)
            s = a_h @ b_h
            if three:
                s = s + a_h @ b_l + a_l @ b_h
            x = s * scale_log2
            if causal:
                live = torch.arange(k0, keys.stop)[None, :] <= qpos[:, None]
                x = torch.where(live, x, pt_fa.NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            ph, pl = pt_fa.split_tf32(p)
            pv = ph @ vh[..., keys, :]
            if three:
                pv = pv + ph @ vl[..., keys, :] + pl @ vh[..., keys, :]
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[..., rows, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def _references(q, k, v, causal):
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    return (np.asarray(ref_fa.flash_attention_ref(jq, jk, jv, causal=causal), np.float32),
            np.asarray(ref_fa.flash_attention_fwd(jq, jk, jv, causal=causal,
                                                  interpret=True), np.float32))


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("h,kv", [(6, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_split_tf32_recurrence_holds_the_float32_contract(hd, h, kv, causal):
    """At the kernel's tiles for each head width, GQA ratios 3 and 4, causal
    and not (T > S): within 2e-5 of the reference's oracle and Pallas
    kernel, and of the port's plain version."""
    s, t = 256, 384
    q, k, v = _inputs(1000 + hd + h + causal, 1, s, t, h, kv, hd)
    got = _split_recurrence(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (1, s, h, hd)
    want_ref, want_kernel = _references(q, k, v, causal)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=TOL, atol=TOL)
    plain = pt_fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL)


def test_split_tf32_recurrence_long_causal_rows():
    """One head, S = T = 2048 at hd 128: 64 k tiles of 32 keys in the last
    rows' recurrence."""
    q, k, v = _inputs(2048, 1, 2048, 2048, 1, 1, 128)
    got = _split_recurrence(*map(torch.from_numpy, (q, k, v)), causal=True)
    want_ref, want_kernel = _references(q, k, v, True)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_product_breaks_the_contract(hd, causal):
    """hi.hi alone (one TF32 product, what a plain TF32 kernel computes) is
    past 2e-5 of the oracle on the inputs the three products hold."""
    q, k, v = _inputs(1000 + hd + 6 + causal, 1, 256, 384, 6, 2, hd)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want_ref, _ = _references(q, k, v, causal)
    three = _split_recurrence(tq, tk, tv, causal=causal)
    one = _split_recurrence(tq, tk, tv, causal=causal, three=False)
    np.testing.assert_allclose(three.numpy(), want_ref, rtol=TOL, atol=TOL)
    assert not np.allclose(one.numpy(), want_ref, rtol=TOL, atol=TOL)
    assert np.abs(one.numpy() - want_ref).max() > 10 * np.abs(three.numpy() - want_ref).max()
