"""Drive the PyTorch/CUDA port of the ODYS search engine on one GPU.

    python3 chip_smoke.py            # the full check, one card

Phases (any failure exits non-zero; nothing is caught):

1. device  — the card's name, power limit and count;
2. build   — nvcc builds every kernel of the query path from
             ``src/repro_torch/kernels/csrc`` (one process per source, all
             at once) and prints ptxas' registers / shared memory / spills;
3. data    — the slice's deployment: a 4M-page corpus from a seed
             (100k terms, mean 64 terms a page, 10k sites), site terms on,
             striped over 4 slaves stacked on the card;
4. K1      — the slave join kernel against its plain PyTorch version,
             bit-exact, on every slave: main-path shapes (32 queries, 4 term
             slots, window 4096) with the attribute filter on and off,
             windows 1000 and 1536, empty lists and the last list of the
             flat array;
5. K2      — the master-merge kernel against its plain version, bit-exact,
             at (Q*ns, 2k) and (Q, ns*k) for k in {10, 50, 1000};
6. serve   — SearchService on the card answers 512 queries of the default
             query mix (k in {10, 50, 1000}); every hit must equal the same
             service with backend="torch"; the kernel launch counters of
             that run must equal what its batches imply; 96 queries on a
             small corpus must equal the brute-force set intersection;
             short passes for the gather and site_term strategies and the
             allgather merge;
7. times   — CUDA-event kernel times beside their bounds, plain versions
             and the library call; served queries/s, per-batch mean and p99;
             peak device memory; then a traced pass (live metrics registry
             and torch.profiler) for the phase split and the device's busy
             share.

The line before the last is the card as ``nvidia-smi`` names it; the one
before that the kernels' JSON record; the last line the result JSON.
Without a CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT32_OPS_PER_S = 67e12        # 32-bit CUDA-core peak (the fp32 figure)
MAIN_WINDOW, MAIN_Q, MAIN_T, NS = 4096, 32, 4, 4


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, *, reps: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def union_length(lo: np.ndarray, hi: np.ndarray) -> int:
    """Total length of the union of the intervals [lo, hi) (non-empty ones)."""
    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    order = np.argsort(lo, kind="stable")
    total, cur_lo, cur_hi = 0, None, None
    for a, b in zip(lo[order].tolist(), hi[order].tolist()):
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=4_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-queries", type=int, default=512)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.engine import (
        StaticPostingSource, _pick_drivers, brute_force_topk, make_query_batch)
    from repro_torch.core.index import (
        InvertedIndex, TILE, build_index, build_sharded_index)
    from repro_torch.core.parallel import slave_topk_unmerged
    from repro_torch.core.perfmodel import QUERY_MIX_DEFAULT
    from repro_torch.core.queries import WorkloadConfig, generate_workload
    from repro_torch.data.corpus import CorpusConfig, corpus_from_docs, generate_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels import posting_intersect as pi
    from repro_torch.kernels import topk_merge as tm
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.serving.search import SearchService

    dev = torch.device("cuda", torch.cuda.current_device())
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    # ------------------------------------------------------------ 1. device
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device_count {torch.cuda.device_count()}")

    # ------------------------------------------------------------ 2. build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc, sm_90a) on {smi}")
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: nvcc {b.seconds:.2f} s; " + " | ".join(ptxas))

    # ------------------------------------------------------------ 3. data
    cfg = CorpusConfig(n_docs=args.n_docs, vocab_size=100_000, mean_doc_len=64,
                       n_sites=10_000, seed=args.seed)
    t0 = time.perf_counter()
    corpus = generate_corpus(cfg)
    t_corpus = time.perf_counter() - t0
    sharded, meta = build_sharded_index(corpus, NS, include_site_terms=True,
                                        device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    n_post = int(sharded.lengths.sum())
    log(f"[data] {cfg}; ns={NS} slaves on one card; {n_post} postings "
        f"({corpus.doc_terms.size} page terms + {corpus.n_docs} site terms); "
        f"index {sharded.nbytes()} device bytes; set-up {t_setup:.1f} s "
        f"(corpus {t_corpus:.1f} s, index build + copy {t_setup - t_corpus:.1f} s)")
    specs = generate_workload(meta, QUERY_MIX_DEFAULT,
                              WorkloadConfig(n_queries=args.n_queries, seed=args.seed))
    queries = [(list(s.terms), s.site) for s in specs]

    # ------------------------------------------------------------ 4. K1
    def k1_inputs(idx: InvertedIndex, batch, window, filt=True):
        src = StaticPostingSource(idx)
        _, d_terms, active = _pick_drivers(src, batch)
        active = active.to(torch.int32)
        span = src.driver_span(d_terms, window)
        plan = pi.plan_driver_streamed(
            span.off, span.n_eff, batch.terms, active, idx.offsets,
            idx.lengths, idx.block_max, window=window)
        attr = batch.attr_filter if filt else torch.full_like(batch.attr_filter, -1)
        return (span.off, span.n_eff, active, attr.contiguous(), idx.postings,
                idx.attrs, *(p.contiguous() for p in plan))

    max_err = {"K1": 0, "K2": 0}

    def k1_check(label, args_, window):
        got = pi.driver_streamed_join_cuda(*args_, window=window)
        torch.cuda.synchronize()
        want = pi.driver_streamed_join_torch(*args_, window=window)
        for g, w, what in zip(got, want, ("docs", "mask")):
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            max_err["K1"] = max(max_err["K1"], err)
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"K1 {label}: {what} differs in {bad} slots")
        return int(want[1].sum())

    main_batch = make_query_batch(queries[:MAIN_Q], t_max=MAIN_T, meta=meta,
                                  strategy="embed", device=dev)
    last_term = meta.n_terms - 1
    for s in range(NS):
        idx = sharded.shard(s)
        lens = idx.lengths
        empty = torch.nonzero(lens == 0)
        common = int(torch.argmax(lens))
        edge_q = [([last_term], None), ([common, last_term], None),
                  ([last_term, common], 1)]
        if empty.numel():
            e = int(empty[0])
            edge_q += [([e], None), ([common, e], None), ([e, common, last_term], None)]
        edge_batch = make_query_batch(edge_q, t_max=MAIN_T, meta=meta, device=dev)
        hits = []
        for label, batch, window, filt in (
            ("main filter-on", main_batch, MAIN_WINDOW, True),
            ("main filter-off", main_batch, MAIN_WINDOW, False),
            ("window 1000", main_batch, 1000, True),
            ("window 1536", main_batch, 1536, True),
            ("empty+last lists", edge_batch, MAIN_WINDOW, True),
            ("empty+last lists w1000", edge_batch, 1000, True),
        ):
            hits.append(k1_check(f"shard {s} {label}",
                                 k1_inputs(idx, batch, window, filt), window))
        log(f"[K1] shard {s}: bit-exact vs plain on 6 cases, mask sums {hits}, "
            f"empty list {'term ' + str(int(empty[0])) if empty.numel() else 'none'}")
    # a tiny index whose last lists start inside the final partial tile
    docs = [np.array([i // 3], np.int32) for i in range(36)] + [np.zeros(0, np.int32)]
    aux = corpus_from_docs(docs, [i % 4 for i in range(37)], vocab_size=14, n_sites=4)
    aux_idx, aux_meta = build_index(aux, include_site_terms=False, device=dev)
    aux_q = [([t], None) for t in range(14)] + [([0, 13], None), ([11, 12], None)]
    aux_batch = make_query_batch(aux_q, t_max=MAIN_T, meta=aux_meta, device=dev)
    for window in (128, 1000, 1024, 1536):
        k1_check(f"array-edge index window {window}",
                 k1_inputs(aux_idx, aux_batch, window), window)
    log("[K1] array-edge index (empty lists, lists in the last partial tile): "
        "bit-exact at windows 128, 1000, 1024, 1536")

    # ------------------------------------------------------------ 5. K2
    k2_inputs = {}
    for k in (10, 50, 1000):
        local = slave_topk_unmerged(sharded, main_batch, ns=NS, k=k,
                                    window=MAIN_WINDOW, backend="torch").docids
        tour = torch.cat([local, local[torch.arange(NS, device=dev) ^ 1]], dim=-1)
        k2_inputs[("tournament", k)] = tour.reshape(NS * MAIN_Q, 2 * k).contiguous()
        k2_inputs[("allgather", k)] = (
            local.permute(1, 0, 2).reshape(MAIN_Q, NS * k).contiguous())
    for (merge, k), x in k2_inputs.items():
        got = tm.merge_topk_rows_cuda(x, k)
        torch.cuda.synchronize()
        plain = tm.merge_topk_rows_torch(x, k)
        max_err["K2"] = max(max_err["K2"],
                            int((got.long() - plain.long()).abs().max()))
        if not torch.equal(got, plain):
            raise AssertionError(f"K2 {merge} k={k} {tuple(x.shape)} differs")
        log(f"[K2] {merge} k={k} shape {tuple(x.shape)}: bit-exact vs plain")

    # ------------------------------------------------------------ 6. serve
    def serve(svc, qs, ks):
        tickets = [svc.submit(t, s, k=k) for (t, s), k in zip(qs, ks)]
        svc.drain()
        return [(t.result.docids, t.result.n_hits) for t in tickets]

    ks = [s.k for s in specs]
    main_kw = dict(ns=NS, window=MAIN_WINDOW, t_max=MAIN_T, batch_size=MAIN_Q,
                   merge="tournament", strategy="embed")
    torch.cuda.reset_peak_memory_stats()
    svc = SearchService(sharded, meta, **main_kw)
    pi.driver_streamed_join_cuda.launches = 0
    tm.merge_topk_rows_cuda.launches = 0
    t0 = time.perf_counter()
    got = serve(svc, queries, ks)
    t_serve = time.perf_counter() - t0
    launches = {"K1": pi.driver_streamed_join_cuda.launches,
                "K2": tm.merge_topk_rows_cuda.launches}
    st = svc.stats()
    executed = st["n_batches"] - st["n_short_circuited"]
    want_launch = {"K1": NS * executed, "K2": int(math.log2(NS)) * executed}
    log(f"[serve] main path: {len(queries)} queries, {st['n_batches']} batches "
        f"({executed} executed, cache hits {st['cache']['hits']}); launches "
        f"{launches}, implied by the batches {want_launch}; {t_serve:.2f} s "
        f"including one-time set-up")
    if launches != want_launch or min(launches.values()) == 0:
        raise AssertionError(f"launch counts {launches} != implied {want_launch}")
    want = serve(SearchService(sharded, meta, backend="torch", **main_kw),
                 queries, ks)
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        raise AssertionError(f"serve: {bad} hits differ from backend='torch'")
    if not any(n for _, n in got):
        raise AssertionError("serve: no query matched anything")
    log(f"[serve] all {len(got)} hits equal backend='torch' on the card; "
        f"total n_hits {sum(n for _, n in got)}")
    # against the brute-force oracle on a corpus whose lists fit the window
    small = generate_corpus(CorpusConfig(n_docs=3000, vocab_size=500,
                                         mean_doc_len=20, n_sites=20,
                                         seed=args.seed))
    s_idx, s_meta = build_sharded_index(small, NS, device=dev)
    if int(s_idx.lengths.max()) > MAIN_WINDOW:
        raise AssertionError("oracle corpus: a list is longer than the window")
    s_specs = generate_workload(s_meta, QUERY_MIX_DEFAULT,
                                WorkloadConfig(n_queries=96, seed=args.seed))
    s_q = [(list(s.terms), s.site) for s in s_specs]
    s_got = serve(SearchService(s_idx, s_meta, **main_kw), s_q,
                  [s.k for s in s_specs])
    truth = brute_force_topk(small, s_q, small.n_docs)
    s_want = [(t[:s.k], len(t)) for t, s in zip(truth, s_specs)]
    if s_got != s_want:
        bad = sum(g != w for g, w in zip(s_got, s_want))
        raise AssertionError(f"serve: {bad} of {len(s_q)} differ from brute force")
    log(f"[serve] {len(s_q)} queries on a 3000-page corpus equal the "
        f"brute-force set intersection (docids and n_hits)")
    for label, kw in (("gather", dict(strategy="gather")),
                      ("site_term", dict(strategy="site_term")),
                      ("allgather", dict(merge="allgather"))):
        kw = {**main_kw, **kw}
        pi.driver_streamed_join_cuda.launches = 0
        tm.merge_topk_rows_cuda.launches = 0
        svc_k = SearchService(sharded, meta, **kw)
        a = serve(svc_k, queries[:64], ks[:64])
        b = serve(SearchService(sharded, meta, backend="torch", **kw),
                  queries[:64], ks[:64])
        st_k = svc_k.stats()
        ex = st_k["n_batches"] - st_k["n_short_circuited"]
        per = int(math.log2(NS)) if kw["merge"] == "tournament" else 1
        lk = (pi.driver_streamed_join_cuda.launches, tm.merge_topk_rows_cuda.launches)
        if a != b or lk != (NS * ex, per * ex):
            raise AssertionError(f"serve {label}: hits equal {a == b}, "
                                 f"launches {lk} vs {(NS * ex, per * ex)}")
        log(f"[serve] {label}: 64 queries equal backend='torch'; launches "
            f"K1 {lk[0]} K2 {lk[1]} as implied by {ex} batches")

    # ------------------------------------------------------------ 7. times
    k1_args = k1_inputs(sharded.shard(0), main_batch, MAIN_WINDOW)
    d_off, d_neff, active, _, _, _, b_tile, n_b, bounds = k1_args
    k1_ms = cuda_ms(lambda: pi.driver_streamed_join_cuda(*k1_args, window=MAIN_WINDOW))
    k1_plain = cuda_ms(lambda: pi.driver_streamed_join_torch(*k1_args, window=MAIN_WINDOW),
                       reps=10, warmup=2)
    lo = bounds[..., 0].long().cpu().numpy()
    hi = bounds[..., 1].long().cpu().numpy()
    bt = b_tile.long().cpu().numpy() * TILE
    nb = n_b.long().cpu().numpy()
    rlo = np.maximum(bt, lo[..., None])
    rhi = np.where(nb > 0, np.minimum(bt + nb * TILE, hi[..., None]), rlo)
    probe = sum(union_length(rlo[q, t], rhi[q, t])
                for q in range(rlo.shape[0]) for t in range(rlo.shape[1]))
    drv = int(d_neff.sum())
    small_in = sum(x.numel() * 4 for x in (d_off, d_neff, active, k1_args[3],
                                          b_tile, n_b, bounds))
    k1_bytes = small_in + drv * 8 + probe * 4 + 2 * MAIN_Q * MAIN_WINDOW * 4
    # one compare per binary-search step, per live driver posting and
    # active other term
    k1_ops = int((d_neff.long() * active.long().sum(1)).sum()) * math.ceil(
        math.log2(MAIN_WINDOW + TILE))
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / INT32_OPS_PER_S) * 1e3
    log(f"[times] K1 window {MAIN_WINDOW}, Q={MAIN_Q}, T={MAIN_T}, shard 0: "
        f"{k1_ms:.4f} ms/launch, {NS} launches/batch; plain {k1_plain:.4f} ms; "
        f"bound {k1_bound:.5f} ms ({k1_bytes} bytes: driver {drv} postings, "
        f"probed {probe} postings) on {smi}")

    k2_rows = {}
    for (merge, k), x in k2_inputs.items():
        ms = cuda_ms(lambda x=x, k=k: tm.merge_topk_rows_cuda(x, k))
        plain = cuda_ms(lambda x=x, k=k: tm.merge_topk_rows_torch(x, k))
        lib = cuda_ms(lambda x=x, k=k: torch.topk(x, k, dim=-1, largest=False,
                                                  sorted=True))
        mpad = tm._padded_width(x.shape[1])
        stages = int(math.log2(mpad)) * (int(math.log2(mpad)) + 1) // 2
        k2_bytes = x.numel() * 4 + x.shape[0] * k * 4
        k2_ops = x.shape[0] * (mpad // 2) * stages * 2
        bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / INT32_OPS_PER_S) * 1e3
        k2_rows[(merge, k)] = (ms, plain, lib, bound, k2_bytes, k2_ops)
        log(f"[times] K2 {merge} k={k} {tuple(x.shape)}: {ms:.4f} ms; plain "
            f"{plain:.4f} ms; torch.topk {lib:.4f} ms; bound {bound:.6f} ms "
            f"({'bytes' if k2_bytes / HBM_BYTES_PER_S >= k2_ops / INT32_OPS_PER_S else 'operations'}) "
            f"on {smi}")

    # served throughput and per-batch response, cache off, after warm-up
    svc_t = SearchService(sharded, meta, cache_size=0, **main_kw)
    batch_s: list[float] = []
    inner = svc_t.scheduler.executor

    def timed_executor(*a):
        t = time.perf_counter()
        out = inner(*a)                 # ends in a device->host copy (sync)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t)
        return out

    svc_t.scheduler.executor = timed_executor
    serve(svc_t, queries[:96], ks[:96])
    batch_s.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = serve(svc_t, queries, ks)
    wall = time.perf_counter() - t0
    if timed != got:
        raise AssertionError("timed pass disagrees with the main-path pass")
    bs = np.array(batch_s)
    log(f"[times] served: {len(queries)} queries in {wall:.4f} s = "
        f"{len(queries) / wall:.1f} queries/s; {bs.size} batches, per-batch "
        f"mean {bs.mean() * 1e3:.3f} ms, p99 {np.percentile(bs, 99) * 1e3:.3f} ms, "
        f"max {bs.max() * 1e3:.3f} ms (host clock around synchronize, cache "
        f"off) on {smi}")
    log(f"[times] peak device memory {torch.cuda.max_memory_allocated()} bytes "
        f"(index {sharded.nbytes()})")

    # traced pass (separate from the timed one): the service's phase split
    # from a live metrics registry, and device busy time from the profiler
    reg = MetricsRegistry()
    svc_p = SearchService(sharded, meta, cache_size=0, registry=reg, **main_kw)
    serve(svc_p, queries[:96], ks[:96])
    reg = MetricsRegistry()
    svc_p = SearchService(sharded, meta, cache_size=0, registry=reg, **main_kw)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(svc_p, queries, ks)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    phases = {labels["phase"]: (h.sum, h.count)
              for name, _, _, series in reg.collect() if name == "odys_phase_seconds"
              for labels, h in series if h.count}
    batches = svc_p.stats()["n_batches"]
    log(f"[trace] {batches} batches in {traced_wall:.4f} s traced; per-batch "
        "phase means (wall, live registry): " + ", ".join(
            f"{p} {s / n * 1e3:.3f} ms" for p, (s, n) in phases.items()
            if p in ("slave_dispatch", "master_merge", "finalize")))
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    n_kern = sum(e.count for e in kern)
    if busy_us > 0:
        log(f"[trace] device busy {busy_us / 1e3:.3f} ms of {traced_wall * 1e3:.3f} "
            f"ms traced wall = {busy_us / (traced_wall * 1e6):.4f} busy share "
            f"(idle {1 - busy_us / (traced_wall * 1e6):.4f}); {n_kern} device "
            f"ops, {n_kern / max(batches, 1):.1f} per batch; top by device time: "
            + "; ".join(f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]))
    else:
        log("[trace] the profiler recorded no device time: busy share not measured")

    k2_main = k2_rows[("tournament", 1000)]
    record = {"kernels": [
        {"name": "K1 driver_streamed_join", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/driver_streamed.cu",
         "replaces": "src/repro/kernels/posting_intersect.py:1207",
         "launches": launches["K1"], "max_abs_err": max_err["K1"],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": "bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / INT32_OPS_PER_S
         else "operations",
         "library_ms": None},
        {"name": "K2 topk_merge_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/topk_merge_rows.cu",
         "replaces": "src/repro/kernels/topk_merge.py:122",
         "launches": launches["K2"], "max_abs_err": max_err["K2"],
         "ms": k2_main[0], "plain_ms": k2_main[1], "bound_ms": k2_main[3],
         "bound_by": "bytes" if k2_main[4] / HBM_BYTES_PER_S >= k2_main[5] / INT32_OPS_PER_S
         else "operations",
         "library_ms": k2_main[2]},
    ]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
