"""The port's op-by-op cost counter and roofline (repro_torch.roofline),
case for case the twin of tests/test_roofline.py, held against the
reference's loop-aware HLO cost model on the same functions."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import registry
from repro_torch.kernels import work as wk
from repro_torch.roofline import analysis as rf
from repro_torch.roofline.op_cost import count_cost


def test_single_matmul_flops():
    n = 512
    a = torch.randn(n, n)
    _, cost = count_cost(lambda x, y: x @ y, a, a)
    assert cost.flops == 2 * n**3
    assert cost.hbm_bytes == 3 * n * n * 4   # two operands in, one out


def test_loop_counts_every_iteration():
    n, t = 256, 8
    ws = torch.randn(t, n, n)

    def f(x, ws):
        for w in ws:
            x = x @ w
        return x

    _, cost = count_cost(f, torch.randn(n, n), ws)
    assert cost.flops == t * 2 * n**3


def test_nested_loops():
    n, t_in, t_out = 128, 4, 3
    ws = torch.randn(t_in, n, n)

    def f(x, ws):
        for _ in range(t_out):
            for w in ws:
                x = x @ w
        return x

    _, cost = count_cost(f, torch.randn(n, n), ws)
    assert cost.flops == t_out * t_in * 2 * n**3


def test_bytes_scale_with_loop():
    n, t = 512, 16
    xs = torch.randn(t, n)

    def f(xs):
        acc = torch.zeros(n)
        for x in xs:
            acc = acc + 2.0 * x
        return acc

    _, cost = count_cost(f, xs)
    assert cost.flops == 0
    assert t * n * 4 < cost.hbm_bytes < 20 * t * n * 4


def test_views_are_free():
    x = torch.randn(64, 64)
    _, cost = count_cost(lambda x: x.t()[1:].unsqueeze(0).expand(2, -1, -1), x)
    assert cost.hbm_bytes == 0 and cost.flops == 0


def test_roofline_terms():
    cost = count_cost(lambda x: x @ x, torch.randn(256, 256))[1]
    r = rf.roofline_from_cost(cost, 1, model_flops=cost.flops)
    assert r.compute_s == pytest.approx(cost.flops / rf.BF16_FLOPS_PER_S)
    assert r.memory_s == pytest.approx(cost.hbm_bytes / rf.HBM_BYTES_PER_S)
    assert r.collective_s == 0.0 and r.useful_ratio == pytest.approx(1.0)
    assert r.dominant in ("compute", "memory")


# ------------------------------------------------- against the reference --
@pytest.mark.parametrize("case", ["matmul", "loop8", "nested"])
def test_flops_equal_the_hlo_cost_model(case):
    import jax
    import jax.numpy as jnp
    from repro.roofline.hlo_cost import analyze

    n = 128
    a = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    ws = np.random.default_rng(1).standard_normal((4, n, n)).astype(np.float32)
    if case == "matmul":
        jfn, tfn, args = (lambda x, w: x @ w[0]), (lambda x, w: x @ w[0]), (a, ws)
    elif case == "loop8":
        def jfn(x, w):
            return jax.lax.scan(lambda h, wi: (h @ wi, None), x, jnp.concatenate([w, w]))[0]

        def tfn(x, w):
            for wi in torch.cat([w, w]):
                x = x @ wi
            return x
        args = (a, ws)
    else:
        def jfn(x, w):
            def outer(h, _):
                return jax.lax.scan(lambda g, wi: (g @ wi, None), h, w)[0], None
            return jax.lax.scan(outer, x, None, length=3)[0]

        def tfn(x, w):
            for _ in range(3):
                for wi in w:
                    x = x @ wi
            return x
        args = (a, ws)
    hlo = jax.jit(jfn).lower(*args).compile().as_text()
    want = analyze(hlo, default_group=1).flops
    _, cost = count_cost(tfn, *(torch.from_numpy(x) for x in args))
    assert cost.flops == pytest.approx(want, rel=0.02)


def test_phi4_mini_naive_forward_flops_match_the_hlo_cost_model():
    """A reduced phi4-mini forward (naive attention), the same weights in
    both packages: op_cost's matmul FLOPs within 2% of hlo_cost's."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduce_for_smoke as ref_reduce
    from repro.models import model as ref_model
    from repro.roofline.hlo_cost import analyze

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy

    name = "phi4-mini-3.8b"
    ref_cfg = dataclasses.replace(ref_reduce(ref_get_config(name)), attn_impl="naive")
    cfg = dataclasses.replace(reduce_for_smoke(get_config(name)), attn_impl="naive")
    ref_params = ref_model.init_model(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    hlo = jax.jit(lambda p, t: ref_model.forward_logits(p, ref_cfg, {"tokens": t})).lower(
        ref_params, jnp.asarray(tokens)).compile().as_text()
    want = analyze(hlo, default_group=1).flops
    with torch.no_grad():
        _, cost = count_cost(model.forward_logits, params, cfg,
                             {"tokens": torch.from_numpy(tokens)})
    assert want > 0
    assert cost.flops == pytest.approx(want, rel=0.02)


def _archs():
    from repro_torch.configs import ARCHS
    return sorted(ARCHS)


@pytest.mark.parametrize("arch", _archs())
def test_model_flops_for_equals_the_reference(arch):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_get_config
    from repro.roofline.analysis import model_flops_for as ref_model_flops_for

    from repro_torch.configs import SHAPES, get_config

    for ref_shape, shape in zip(REF_SHAPES, SHAPES):
        assert shape.name == ref_shape.name
        assert rf.model_flops_for(get_config(arch), shape) == ref_model_flops_for(
            ref_get_config(arch), ref_shape)


def test_model_flops_formula():
    from repro_torch.configs import SHAPES_BY_NAME, get_config

    f = rf.model_flops_for(get_config("deepseek-coder-33b"), SHAPES_BY_NAME["train_4k"])
    assert f == pytest.approx(6 * 33e9 * 256 * 4096, rel=0.2)
    assert 11e9 < get_config("mixtral-8x7b").n_active_params() < 15e9


def test_attention_keys():
    assert wk.attention_keys(100, 100, causal=True) == 100 * 101 // 2
    assert wk.attention_keys(100, 100, causal=True, window=30) == wk.window_keys(100, 30)
    assert wk.attention_keys(7, 1500, causal=False) == 7 * 1500


# ------------------------------------------------------- kernel dispatch --
def _dispatch_calls():
    """(entry, dispatcher call on a contract instance's arguments)."""
    from repro_torch.core.index import BLOCK
    from repro_torch.kernels import delta_merge as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import posting_intersect as pi
    from repro_torch.kernels import topk_merge as tm

    def merge(packed):
        # d_block_max only gives the cap: its shape, made before the count
        bmax = {}

        def call(m, a, mo, mn, d, da, do, dl, t, *, window, cap):
            kw = dict(packed=m, d_packed=d) if packed else {}
            return dm.merge_delta_windows(m, a, mo, mn, d, da, do, dl, bmax[cap], t,
                                          window=window, **kw)
        for cap in (256, 16384):
            bmax[cap] = torch.zeros(12 * cap // BLOCK, dtype=torch.int32)
        return call

    return {
        "driver_streamed": pi.driver_streamed_join,
        "driver_streamed_packed": pi.driver_streamed_join_packed,
        "streamed_join": pi.streamed_join, "streamed_join_packed": pi.streamed_join_packed,
        "driver_compact": pi.driver_compact_join,
        "driver_compact_packed": pi.driver_compact_join_packed,
        "streamed_compact": pi.streamed_compact_join,
        "streamed_compact_packed": pi.streamed_compact_join_packed,
        "batched_block_skip": pi.batched_block_skip_join,
        "block_skip": pi.block_skip_join,
        "delta_merge": merge(False), "delta_merge_packed": merge(True),
        "delta_merge_packed_row": merge(True),
        "topk_merge_rows": tm.merge_topk_rows,
        "flat_sort_i32": tm.bitonic_sort, "flat_sort_f32": tm.bitonic_sort,
        "flash_attention_f32": fa.flash_attention_fwd,
        "flash_attention_bf16": fa.flash_attention_fwd,
    }


@pytest.mark.parametrize("entry", sorted(_dispatch_calls()))
def test_kernel_dispatch_reports_its_contract_work(entry):
    """On CPU tensors a dispatcher runs the plain version, and the count is
    the launch contract's work, once: the plain version's ops are not
    counted."""
    (c,) = registry.load_contracts([entry])
    inst = c.instances[0]
    fn = _dispatch_calls()[entry]
    got, cost = count_cost(fn, *inst.args, **inst.kwargs)
    work = registry.work(entry, *inst.args, **inst.kwargs)
    # the packed merges' chunk and row forms do the same work: one entry
    assert cost.kernels == {entry.removesuffix("_row"): 1}
    assert cost.hbm_bytes == work.bytes
    assert cost.kernel_ops == {work.unit: work.ops}
    assert cost.flops == 0
    ms, by, w = rf.kernel_bound(entry, *inst.args, **inst.kwargs)
    assert w == work and (ms, by) == rf.bound_ms(work.bytes, work.ops, work.unit)


def test_compact_merge_dispatch_reports_its_table_work():
    """K8 through its orchestrator: the table it builds is the one whose
    work is counted."""
    from repro_torch.core.index import BLOCK
    from repro_torch.kernels import delta_merge as dm

    (c,) = registry.load_contracts(["merge_compact"])
    desc, heads, *args = c.instances[0].args
    window, cap = c.instances[0].kwargs["window"], c.instances[0].kwargs["cap"]
    bmax = torch.zeros(args[6].numel() * cap // BLOCK, dtype=torch.int32)
    m, a, mo, mn, d, da, do, dl, t = args
    _, cost = count_cost(dm.merge_delta_windows_compact, m, a, mo, mn, d, da, do, dl,
                         bmax, t, window=window)
    wl = dm.plan_merge_compact(mn, window=window)
    from repro_torch.kernels.worklist import table_to_device
    desc_all, heads_all = table_to_device(wl, "cpu")
    # beside the kernel, only the table's upload is counted
    assert cost.kernels == {"merge_compact": 1}
    assert set(cost.by_op) == {"aten.cat"}
    upload = cost.by_op["aten.cat"][2]
    assert cost.hbm_bytes - upload == registry.work(
        "merge_compact", desc_all, heads_all, *args, window=window, cap=cap).bytes


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
def test_train_loss_gradient_counts_k12_once_a_forward(remat):
    """A ``train_loss`` gradient of a reduced phi4-mini: K12's forward under
    the gradient (``K12Attention``) reports its contract's work once per
    attention layer, twice with the remat recompute, and its plain
    version's ops are not counted; the backward's products are."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model

    cfg = dataclasses.replace(reduce_for_smoke(get_config("phi4-mini-3.8b")),
                              remat_layers=remat)
    params = model.init_model(cfg, seed=0, device="cpu").requires_grad_(True)
    inputs = model.make_inputs(cfg, 2, 24, seed=0, device="cpu")

    def step(p):
        loss = model.train_loss(p, cfg, inputs)
        loss.backward()
        return loss

    _, cost = count_cost(step, params)
    B, S, H, KV, hd = 2, 24, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.zeros(B, S, H, hd, dtype=cfg.cdtype)
    k = torch.zeros(B, S, KV, hd, dtype=cfg.cdtype)
    entry = fa.k12_entry(q)
    per_layer = 2 if remat else 1
    assert cost.kernels == {entry: per_layer * cfg.n_layers}
    work = registry.work(entry, q, k, k, causal=True, q_chunk=S, k_chunk=S,
                         window=cfg.sliding_window)
    assert cost.kernel_ops == {work.unit: per_layer * cfg.n_layers * work.ops}
    assert cost.flops > 0
