"""Drive the PyTorch/CUDA port of the ODYS search engine on one GPU.

    python3 chip_smoke.py                                  # the full check
    python3 chip_smoke.py --n-docs 200000 --n-queries 128  # a short rehearsal

Phases (any failure exits non-zero; nothing is caught):

1. device  — the card's name, power limit and count;
2. build   — nvcc builds every kernel (K1–K4, the work-list kernels
             K6–K8, the staged joins K9 and K10, the flat sort K11, the
             flash-attention forward K12, and the packed modes K1p, K3p,
             K4p, K6p, K7p, K8p) from
             ``src/repro_torch/kernels/csrc`` (one process per source, all
             at once) and prints ptxas' registers / shared memory / spills
             (K2, K3, K3p, K8, K8p, K9, K10 and K12 float32 on a line of
             their own); a spill fails;
3. data    — the deployment: a 4M-page corpus from a seed (100k terms,
             mean 64 terms a page, 10k sites), site terms on, striped over
             4 slaves stacked on the card;
4. K1      — the static slave join against its plain PyTorch version,
             bit-exact, on every slave: main-path shapes (32 queries, 4 term
             slots, window 4096) with the attribute filter on and off,
             windows 1000 and 1536, empty lists and the last list of the
             flat array;
5. K2      — the master-merge kernel against its plain version, bit-exact,
             at (Q*ns, 2k) and (Q, ns*k) for k in {10, 50, 1000}, and on
             edge rows: m = 1, 257 and 4000 with k past m, duplicates,
             INT_MIN, all-INVALID_DOC, a single row;
6. serve   — the static path: SearchService answers 512 queries of the
             default mix (k in {10, 50, 1000}) equal to backend="torch",
             with the launch counters its batches imply; 96 queries on a
             small corpus equal brute force; the gather and site_term
             strategies and the allgather merge;
7. times   — static path: K1/K2 CUDA-event and profiler times beside
             bounds, plain versions and the library calls (K2 at all six of
             phase 5's shapes, beside torch.sort of the padded rows and
             torch.topk); K1's staging precondition on its plan; its
             staging from the plans on the host, the first design's
             (1024-slot tiles, 2048-posting chunks) beside this one's
             (blocks, postings staged in all and by the busiest block, the
             longest chain, shared memory a block); served queries/s,
             per-batch mean and p99; peak memory; a traced pass (phase
             split, busy share, the hand-written kernels among the device
             events);
8. updates — merge-on-read on the same index: a packed DeltaWriter (term
             capacity 256, doc headroom 4096; the service reads its raw
             snapshot) takes a mixed insert/delete/update
             stream op by op until its hottest list is empty (fill 0), half
             full and full.  At each fill: seconds per ``device_delta()``
             snapshot; K3 and K4 against their plain versions, bit-exact, on
             every slave (main-path drivers; hot, rare, inert and
             empty-main-list drivers; windows 4096, 1000, 256; K4 with the
             filter on and off); an updatable SearchService answers the 512
             queries equal to backend="torch" with K3 = K4 = 4, K2 = 2 and
             K1 = 0 launches per executed batch; served queries/s and
             per-batch times, cache off; a query repeated after a mutation
             is recomputed, not served stale; then K3 at the chunk edges of
             ``merge_edge_inputs`` (equal docIDs at chunk starts, merged
             lengths ending inside a chunk, empty and full streams) at
             windows 4096, 1000, 256, 65536 and caps 256, 384, and at
             window 65536 with cap 16384, merged out of global memory;
9. small   — a 3000-page corpus with a writer of term capacity 384 (BLOCK-
             but not TILE-aligned), a mixed stream, a driver list
             tombstoned wall to wall and lists empty in the main index with
             delta postings: K3/K4 bit-exact; served hits equal brute force
             over the mutated corpus, before and after compact(verify=True);
10. mor-times — at fill 1.0: K3/K4 CUDA-event times beside bounds, plain
             versions and the library sort; K3 against the host replay of
             its chunks, and their staging; K4's staging precondition and
             its staging before and after, as K1's in phase 7;
             peak device memory; a traced pass; then the full-size delta
             compacted into a fresh index, served equal to
             backend="torch";
11. packed — the block-codec read path (K5): each slave packed with
             ``pack_index`` (seconds, bytes, the width histogram, which must
             hold widths 0 and 32; the decode equals the raw postings; one
             slave's device pack equals its CPU pack); K1p bit-exact against
             its plain version and raw K1 on every slave in phase 4's cases
             and on the array-edge index, and against the numpy decode on a
             synthetic array of every width; a packed writer replaying phase
             8's stream: at fills 0, 0.5, 1.0 K3p and K4p bit-exact against
             their plain versions and raw K3/K4 on every slave (phase 8's
             cases and window 65536), and seconds per packed
             ``shard_deltas()`` version; K3p at phase 8's chunk edges and at
             window 65536 with a cap (16384) that takes its large-cap form,
             window 65536 at cap 256 through the chunk form; the 512 queries
             through ``sequential_reference(codec="packed",
             backend="kernel")`` with every raw posting array zeroed, equal
             to ``backend="torch", codec="raw"`` and to the raw service, K1p
             = 4 (static) and K3p = K4p = 4 (fill 1.0) launches per batch and
             no raw join; the 3000-page corpus with a packed writer of term
             capacity 384 against brute force before and after
             ``compact(verify=True)`` and ``pack_index``; K1p/K3p/K4p times
             beside bounds and plain versions, K3p against the host replay
             of its chunks (blocks decoded); and for K1p and K4p the
             staging precondition on the twins and the staging before and
             after; packed against raw per-batch time, interleaved;
12. compact — work-list compaction (``backend="kernel_compact"``): K6 and
             K6p bit-exact against their plain versions (which execute the
             descriptor table) and, on live rows, against K1 / K1p, on every
             slave in phase 4's cases; at fills 0, 0.5, 1.0 (phase 11's
             writer versions) K8/K8p and K7/K7p likewise against K3/K3p and
             K4/K4p in phase 8's cases; each under live_q all live, the last
             rows inert clones of the last live query, one live and every
             other live, with inert rows as specified, and an all-inert batch
             that launches nothing; K6/K6p and K7/K7p likewise at window
             65536 on queries whose groups pass 32 rows and hold dead-term
             and no-op groups, and K7/K7p over tables recompiled with two
             more tiles in each run of one kind (delta tiles outlasting
             main ones, and the reverse); the 512 queries through
             ``sequential_reference(backend="kernel_compact")`` on the static
             index and at fill 1.0, raw and packed (raw postings zeroed),
             equal to ``backend="kernel"`` and ``"torch"`` with K6 (K6p) = 4
             and K8 = K7 = 4 (K8p, K7p) launches per batch and no dense
             join; K8/K8p at phase 8's chunk edges (``merge_edge_inputs``,
             windows 4096, 1000, 256, 65536, caps 256 and 384, and 65536 at
             cap 16384) through a work list under live_q all / one /
             alternate, bit-exact against their plain versions and K3/K3p,
             and the form K8p launched, from the profiler's trace: its chunk
             kernel wherever ``chunk_fits`` (and at the main path's shapes,
             K8's too), its row kernel elsewhere; the 3000-page corpus
             against brute force before and after
             ``compact(verify=True)``; K6–K8p times beside bounds and plain
             versions; for K6, K6p, K7, K7p the staging from the table's
             streams, the first design's (one block a group, one
             synchronous tile a row) beside this one's, and device ms
             beside the dense twins K1, K1p, K4, K4p at all 32 and at 20 of
             32 live; the host work per table, the occupancy gauge, and the
             slave phase's per-batch time (dense against compact in turns)
             and its device ops and busy share, at all 32 live and at 20 of
             32 live;
13. staged — the staged comparator (``backend="kernel_staged"``) and the
             kernel-level ops: K9 bit-exact against its plain version on
             every slave (main-path shapes with the filter on and off,
             windows 1000 and 1536, empty drivers and inactive slots,
             other-term windows narrower and wider than the driver's, and at
             fill 1.0 with ``a_live``; other-term windows of 65536 whose skip
             ranges pass one round of the probe's buffer, a first term that
             kills every slot, ``a_live`` null against all ones); K9's skip
             ranges at the main path's shapes against the staging
             precondition (``skip_streams``) and its grid from the
             profiler's trace (512 blocks); K10 on the reference kernel tests'
             shapes, ``bench_kernels.py``'s, the two hottest lists of
             slave 0 whole, skip ranges past one round of the probe's
             buffer and an empty other list (mask 0), with its streams
             (``skip_streams``) and grid from the profiler's trace; K11
             (int32, float32) from 2 to 2**20 keys (the tile's edges,
             2**18 + 1), sorted, reversed, one-value and
             all-``INVALID_DOC`` vectors, the pad quirk with ``inf`` and 3e9,
             and ``merge_topk``; the launches of one 2**20 sort (1 +
             log2(m / tile), from the profiler); the static
             modes of K4, K4p, K7, K7p against their plain versions and K9
             on the staged windows of the same drivers; the ``ops`` entry
             points with their launch counts; the 512 queries through
             ``sequential_reference(backend="kernel_staged")`` with K9 = 4
             and no other launch per batch, equal to ``"kernel"`` and
             ``"torch"`` on the static index, and at fill 1.0 equal to a
             plain oracle of the staged semantics (the count of queries on
             which those differ from the streamed path's is printed); one
             packed batch equal to raw; times of K9, K10, K11 and the static
             modes beside bounds, plain versions and library calls, and
             K7s/K7ps beside K4s/K4ps at all 32 and at 20 of 32 live; the
             staged path against ``"kernel"`` per batch, interleaved, with
             device ops; an updatable staged service after a mutation;
14. flash  — K12 (``flash_attention_fwd``) within rtol = atol = 2e-5
             (float32) and 2e-2 (bfloat16) of its plain version and of
             ``flash_attention_ref`` at every shape of
             ``tests/test_flash_kernel.py`` (float32; bfloat16 twins of the
             hd 128 and the non-causal T > S hd 64 ones) and at the full
             attention width of phi4-mini-3.8b (H 24, KV 8, hd 128; S = T =
             4096) and gemma-2b (H 8, KV 1, hd 256; S = T = 2048), float32
             and bfloat16, a rectangular-chunk and a non-causal T > S case,
             and tiles that overhang S and T (S = T = 192, S = 64 with T =
             96, GQA 3 at hd 64), in both dtypes, one launch a call; every
             bfloat16 case also within a row-relative error of
             ``BF16_ROW_REL_TOL`` (0.05), and an emulated ring fault (one
             k/v tile of a long row left out, or V from the slot's
             previous tile) at the phi4-mini and gemma-2b shapes read past
             it, and past 2e-5 with the float32 kernel's tiles; the HGMMA
             count of each K12 kernel's SASS (``cuobjdump -sass``; none in
             the bf16 or the float32 kernel fails); at the phi4-mini and
             gemma-2b shapes, each dtype, CUDA-event and profiler times
             beside the bound (float32: the split-TF32 bound, 3 x flops at
             495 TFLOP/s, and the CUDA-core one), the plain version and
             ``scaled_dot_product_attention(enable_gqa=True)``;
15. ingest — multi-master ingest on phase 3's index: a
             ``ShardedDeltaWriter`` (term capacity 256, doc headroom 4096)
             takes phase 8's stream from 4 ingest threads through its
             queues, one drain worker a shard, while the main thread serves
             the 512 queries; every executed batch equals
             ``backend="torch"`` on the snapshot it read; after the joins
             the snapshot equals a sequential ``DeltaWriter`` oracle field
             by field, ``sum(version.seqs)`` the ops applied and the
             conflicts counter the ops dropped; the 512 queries with K3 =
             K4 = 4 and K2 = 2 launches a batch; a query cached before a
             mutation on another shard is recomputed; publish seconds
             (base writer, one shard moved, four), ingest ops/s at 1 and 4
             threads, peak memory; three ``compact(verify=True)`` racing
             two insert threads on the 3000-page corpus, then hits equal
             brute force;
16. model  — the paper's hybrid performance model on phase 3's index:
             ``calibrate_from_engine`` (ns 4, window 4096, t_max 4, q 32,
             reps 4, k in {10, 50, 1000}, tournament merge,
             ``backend="kernel"``), every timed call ending in a device
             synchronise; the launch counters over it equal exactly what
             the reps and merge widths imply (K1 = 4 per timed slave-phase
             or master-path call, K2 on every merge, nothing else); the
             merge fit's t_comparison, t_base and raw per-(k, w) times,
             st_slave / st_master / slave_max per k, the fitted
             MasterParams, all finite and positive; the master/network
             max stable load (single top-10) in queries/s and per day,
             the whole-model one (slave tier included), projections at
             0.25 / 0.5 / 0.75 of each; a 512-query Poisson replay at half
             the two-set model's stable load through a health-aware
             two-set ``SearchService`` (cache off, batch 32, max_wait the
             time 32 arrivals take) with ``ModelResidualMonitor`` as span
             sink, set 1 failed after a third of the trace and recovered
             after two thirds: every ticket done, no batch routed to a dead
             set, hits equal ``backend="torch"``, transitions 1 dead and 1
             alive, ``odys_model_residual`` finite (printed beside the
             measured mean and the projection, not gated), K1 = 4 and K2 =
             2 a batch; every set dead: dispatch raises and keeps the
             tickets; a cached pass on the same registry; Prometheus text
             and JSON rendered with every required family and phase; and
             ``python -m repro_torch.obs demo / check / inert`` on the
             card;
17. lm     — the LM serving path at phi4-mini-3.8b's full width and depth
             (32 layers, d 3072, H 24, KV 8, hd 128, d_ff 8192, vocab
             200064; bfloat16, random weights from the seed; no cut):
             parameter count and init seconds; on a float32 twin of the
             same weights (TF32 off), ``forward_logits`` of B = 2, S = 1000
             tokens with ``attn_impl="flash"`` (K12 float32, 32 launches)
             within a row-relative error of 1e-3 of ``"naive"`` at every
             position; bfloat16 last-position logits of flash (K12
             bfloat16) no further from the float32 ones than 1.5 times the
             naive bfloat16 path's; ``prefill`` of 992 tokens and 8
             teacher-forced ``decode_step``s within 1e-3 of the full
             forward; ``ServingEngine(batch_size=4, max_len=1040)`` serving
             8 requests (prompts of 128 to 1024 tokens from the seed, 16
             new tokens): 16 tokens each in ``[0, vocab)``, the first batch
             served again gives the same outputs, K12 = 32 a prefill (64)
             and none in decode, nothing else launched; prefill ms a batch,
             decode ms a token, tokens/s, peak memory; ``python -m
             repro_torch.launch.serve --arch gemma-2b`` (full width, hd
             256, MQA, tied head) on the card, rc 0 and K12 = 36; K12 at
             the first served prefill's shape beside its bound, plain
             version and SDPA;
18. lm-moe-hybrid — the MoE and hybrid families at full width and depth
             (bfloat16, random weights from the seed), after phase 17's
             model is freed; prints the bytes earlier phases hold.  (i) K12
             with a window at recurrentgemma-2b's local attention (B 2, S
             = T = 4096, H 10, KV 1, hd 256, W 2048) in bfloat16 and
             float32 against its plain version and the full-logits
             oracle (2e-5; 2e-2 and a row-relative 0.05), and at edges:
             S = 3000, W = 37, W >= S (bit-equal to no window), hd 128 and
             hd 64; its time beside its bound (operations over sum min(i
             + 1, W) keys) and SDPA with the boolean window mask.  (ii)
             recurrentgemma-2b (26 layers: 8 x (rglru, rglru, local) +
             (rglru, rglru), d 2560, lru 2560, vocab 256000, tied head):
             the parameter count against the shapes; on a float32 twin
             at B 2, S 3000, the flash forward (8 windowed K12 launches)
             within a row-relative 1e-3 of ``"naive"``, prefill of 2992
             + 8 decode steps within 1e-3 of the forward;
             ``ServingEngine(batch_size=2)`` serving 4 prompts of
             2500–4096 tokens x 16: K12 = 8 a prefill, every one at
             window 2048, none in decode, the first batch again equal.
             (iii) Moonlight-16B-A3B (48 layers, d 2048, 64 experts of
             d_ff 1408, top-6, vocab 163840): on a float32 twin cut to 4
             layers, flash vs naive at B 2, S 1000 and, on a no-drop
             capacity copy (cf 11), prefill + decode vs the forward;
             the full model's count and init seconds;
             ``ServingEngine(batch_size=4, max_len=1040)`` at cf 1.25
             serving 8 prompts of 128–1024 tokens x 16: K12 = 48 a
             prefill, none in decode, equal outputs again, the share of
             (token, slot) pairs dropped at capacity.  Prefill ms a
             batch, decode ms a token, tokens/s and peak memory of both.

Every phase prints its seconds.

The line before the last is the card as ``nvidia-smi`` names it; the one
before that the kernels' JSON record; the last line the result JSON.
Without a CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import inspect
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT32_OPS_PER_S = 67e12        # 32-bit CUDA-core peak (the fp32 figure)
FP32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # TF32 tensor cores, dense (split TF32: 3 products)
BF16_FLOPS_PER_S = 989e12      # bf16 tensor cores, dense
MAIN_WINDOW, MAIN_Q, MAIN_T, NS = 4096, 32, 4, 4
TERM_CAPACITY, DOC_HEADROOM = 256, 4096
FILLS = (0.0, 0.5, 1.0)
MOR_WINDOWS = (4096, 1000, 256)
BIG_WINDOW = 65536             # a window whose whole K3p row passes the opt-in shared memory
LARGE_CAP = 16384              # K3/K3p's chunk forms pass shared memory here
KERNEL_NAMES = {"K1": "driver_streamed_kernel",
                "K2": ("topk_merge_warp_kernel", "topk_merge_runs_kernel"),
                "K3": "delta_merge_kernel",
                "K4": "streamed_join_kernel",
                "K1p": "driver_streamed_packed_kernel",
                "K3p": ("delta_merge_packed_kernel", "delta_merge_packed_row_kernel"),
                "K4p": "streamed_join_packed_kernel",
                "K6": "driver_compact_kernel", "K6p": "driver_compact_packed_kernel",
                "K7": "streamed_compact_kernel", "K7p": "streamed_compact_packed_kernel",
                "K8": "merge_compact_kernel",
                "K8p": ("merge_compact_packed_kernel", "merge_compact_packed_row_kernel"),
                "K9": "staged_join_kernel", "K10": "skip_join_kernel",
                "K11": ("flat_sort_tile", "flat_sort_merge"),
                "K12": ("flash_attention_tf32_kernel", "flash_attention_wgmma_kernel")}


def kernel_names(key: str) -> tuple:
    """The ``__global__`` names of kernel ``key`` (K2, K3p, K8p, K11 and K12
    have two)."""
    names = KERNEL_NAMES[key]
    return (names,) if isinstance(names, str) else names


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_info(nvcc_log: str) -> dict:
    """``ptxas -v``'s registers and spills of each kernel in an nvcc log,
    keyed by the mangled name cut to the kernel's name and template
    arguments (``flash_attention_wgmma_kernel<128>``, ``flat_sort_tile<i>``)."""
    info, fn = {}, None
    for line in nvcc_log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[1].strip()
            m = re.match(r"_Z(\d+)(.*)", fn)
            if m:
                n, rest = int(m.group(1)), m.group(2)
                args = rest[n:]
                args = re.sub(r"Li(\d+)E", r"\1,", args[1:args.find("Ev")]).rstrip(
                    ",") if args.startswith("I") else ""
                fn = rest[:n] + (f"<{args}>" if args else "")
            info[fn] = []
        elif fn is not None and ("spill" in line or "registers" in line):
            info[fn].append(line.split(":", 1)[-1].strip() if "registers" in line
                            else line.strip())
    return {fn: "; ".join(parts) for fn, parts in info.items()}


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


def device_ms(fn, *, reps: int = 20, kernel: str | None = None) -> float:
    """Device milliseconds per call of ``fn()``: the profiler's device time
    summed over every kernel the call launches, averaged over ``reps``
    calls.  Unlike ``cuda_ms`` it leaves out the gaps in which the device
    waits for the host to launch the next call.  The profiler loses the
    first few events of a window, more of them the longer the process has
    run (none early, 3 to 8 by the later phases, whatever the kernels),
    and a window that lost some under-reads: so each window opens with 64
    short spin kernels (left out of the reading), and it counts only when
    its count is right.  With ``kernel`` (a key of ``KERNEL_NAMES``, for a
    call that launches that kernel once and nothing else) only that
    kernel's events are read, and the window must hold exactly ``reps`` of
    them; without, every device event is read, and two windows in a row
    must hold the same count, a whole number per call.  Up to four
    windows; 0.0 (not measured, with the counts logged) when none counts."""
    fn()
    torch.cuda.synchronize()
    names = None if kernel is None else kernel_names(kernel)
    want = None if kernel is None else reps
    counts = []
    for _ in range(4):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.key
                  and (names is None or any(n in e.key for n in names))]
        count = sum(e.count for e in events)
        total = sum(e.self_device_time_total for e in events)
        counts.append(count)
        if total > 0 and count == want:
            return total / reps / 1e3
        if names is None:
            want = count if count > 0 and count % reps == 0 else None
    log(f"[profiler] not measured: {kernel or 'all'} events in {len(counts)} windows "
        f"of {reps} calls: {counts}")
    return 0.0


def kernel_launches(fn, *, calls: int = 3) -> dict:
    """The device kernels that ``calls`` calls of ``fn()`` launch:
    ``{name: (launches, grids)}``, the launches from the profiler's device
    events and ``grids`` the ``(grid, block)`` pairs its trace gives each
    (an empty set where the trace does not).  A window opens with 64 short
    spin kernels (left out), as ``device_ms``'s do; a window that holds no
    event of ``fn`` is taken again, up to four."""
    fn()
    torch.cuda.synchronize()
    counts = {}
    for _ in range(4):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.key}
        if counts:
            break
    grids = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    for e in events:
        a = e.get("args", {})
        if e.get("cat") == "kernel" and "grid" in a:
            grids.setdefault(e.get("name"), set()).add(
                (tuple(a["grid"]), tuple(a.get("block", ()))))
    return {n: (c, grids.get(n, set())) for n, c in counts.items()}


def launched_forms(fn, key: str) -> set:
    """Which of kernel ``key``'s ``__global__`` names ``fn()`` launched (from
    ``kernel_launches``); raises if it launched none of them."""
    launched = kernel_launches(fn)
    names = {n for k in launched for n in kernel_names(key) if n in k}
    if not names:
        raise AssertionError(f"{key}: no launch of {kernel_names(key)} among the "
                             f"device events {sorted(launched)}")
    return names


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


def probed_postings(b_tile, n_b, bounds, tile) -> int:
    """Postings a probe plan reads: per (query, term) the union of its
    planned ranges [max(b_tile*TILE, lo), min((b_tile+n_b)*TILE, hi))."""
    lo = bounds[..., 0].long().cpu().numpy()
    hi = bounds[..., 1].long().cpu().numpy()
    bt = b_tile.long().cpu().numpy() * tile
    nb = n_b.long().cpu().numpy()
    rlo = np.maximum(bt, lo[..., None])
    rhi = np.where(nb > 0, np.minimum(bt + nb * tile, hi[..., None]), rlo)
    return sum(union_length(rlo[q, t], rhi[q, t])
               for q in range(rlo.shape[0]) for t in range(rlo.shape[1]))


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def range_blocks(lo: np.ndarray, hi: np.ndarray, block: int) -> np.ndarray:
    """The distinct blocks that hold the positions of the ranges [lo, hi)."""
    keep = hi > lo
    firsts, lasts = lo[keep] // block, (hi[keep] - 1) // block
    if firsts.size == 0:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate([np.arange(a, b + 1)
                                     for a, b in zip(firsts.tolist(), lasts.tolist())]))


def probed_ranges(b_tile, n_b, bounds, tile):
    """The planned probe ranges [rlo, rhi) of a plan, each [Q, T, A]."""
    lo = bounds[..., 0].long().cpu().numpy()
    hi = bounds[..., 1].long().cpu().numpy()
    bt = b_tile.long().cpu().numpy() * tile
    nb = n_b.long().cpu().numpy()
    rlo = np.maximum(bt, lo[..., None])
    rhi = np.where(nb > 0, np.minimum(bt + nb * tile, hi[..., None]), rlo)
    return rlo, rhi


def packed_block_cost(blocks: np.ndarray, meta_host: np.ndarray) -> tuple[int, int]:
    """``(bytes, blocks)`` a packed kernel must read to decode ``blocks``:
    each block's packed words (4 * width words of 4 bytes) and its 12
    descriptor bytes.  ``meta_host`` is the twin's ``blk_meta`` up to
    ``n_blocks``."""
    blocks = blocks[blocks < meta_host.shape[0]]
    widths = meta_host[blocks] & 63
    return int((widths.astype(np.int64) * 16).sum()) + 12 * int(blocks.size), int(blocks.size)


def probe_block_cost(b_tile, n_b, bounds, tile, meta_host) -> tuple[int, int]:
    """``packed_block_cost`` of a probe plan: per (query, term) the blocks
    of the union of its planned ranges (the convention of
    ``probed_postings``), summed."""
    rlo, rhi = probed_ranges(b_tile, n_b, bounds, tile)
    costs = [packed_block_cost(range_blocks(rlo[q, t], rhi[q, t], 128), meta_host)
             for q in range(rlo.shape[0]) for t in range(rlo.shape[1])]
    return sum(c[0] for c in costs), sum(c[1] for c in costs)


def span_block_cost(start, length, meta_host) -> tuple[int, int]:
    """``packed_block_cost`` of each row's span [start, start + length),
    summed over rows (int tensors of one shape)."""
    lo = start.long().cpu().numpy().reshape(-1)
    hi = lo + length.long().cpu().numpy().reshape(-1)
    costs = [packed_block_cost(range_blocks(lo[i:i + 1], hi[i:i + 1], 128), meta_host)
             for i in range(lo.shape[0])]
    return sum(c[0] for c in costs), sum(c[1] for c in costs)


def table_probe_cost(desc_h, n_items, bounds_h, col, tile, meta_host=None):
    """What a work list's probe tiles in column ``col`` (3 main, 5 delta)
    read: per (query, term) the union of its rows' tiles clipped to the
    term's bounds, as postings, or with the twin's ``meta_host`` as the
    ``packed_block_cost`` of the blocks that hold them."""
    it = desc_h[:n_items].astype(np.int64)
    it = it[it[:, col] >= 0]
    b = bounds_h[it[:, 0], it[:, 2]].astype(np.int64)
    lo = np.maximum(it[:, col] * tile, b[:, 0])
    hi = np.minimum((it[:, col] + 1) * tile, b[:, 1])
    keys = it[:, 0] * 64 + it[:, 2]
    postings, n_bytes, n_blocks = 0, 0, 0
    for key in np.unique(keys):
        m = keys == key
        if meta_host is None:
            postings += union_length(lo[m], hi[m])
        else:
            c = packed_block_cost(range_blocks(lo[m], hi[m], 128), meta_host)
            n_bytes, n_blocks = n_bytes + c[0], n_blocks + c[1]
    return postings if meta_host is None else (n_bytes, n_blocks)


# the first design's staging (a synchronous probe, no longer in the tree:
# one block a 1024-slot tile, 2048-posting chunks, a static buffer of
# CHUNK + BLOCK ints)
OLD_CHUNK, OLD_SMEM = 2048, (2048 + 128) * 4


def probe_streams_host(plans, act):
    """Each stream's planned ranges ``(rlo, rhi)`` [Q, S, A] (S = T * kinds,
    stream t * kinds + kind) from the plans (main, then delta), with the
    ranges of inactive terms emptied."""
    rl, rh = [], []
    for b_tile, n_b, bounds in plans:
        lo, hi = probed_ranges(b_tile, n_b, bounds, 1024)
        rl.append(lo)
        rh.append(np.maximum(hi, lo))
    rlo = np.stack(rl, axis=2).reshape(lo.shape[0], -1, lo.shape[2])
    rhi = np.stack(rh, axis=2).reshape(lo.shape[0], -1, lo.shape[2])
    on = np.repeat(act.astype(bool), len(plans), axis=1)[..., None]
    return rlo, np.where(on, rhi, rlo)


def chain_before(rlo, rhi, widths=None):
    """The first design's staging, per (query, 1024-slot tile) block: every
    planned range in 2048-posting chunks, one load and two barriers each
    (packed: each chunk's blocks decoded from global memory, a descriptor
    and a word load per block, eight warps).  Returns ``(blocks, staged,
    busiest, longest)``: postings staged in all and by the busiest block,
    and the most dependent loads on one block's chain."""
    n = np.maximum(rhi - rlo, 0)
    chunks = -(-n // OLD_CHUNK)
    if widths is None:
        loads = chunks.sum(1)
    else:   # 2 loads per decode pass of 8 blocks, per chunk of 16 blocks
        loads = (chunks * 2 * 2).sum(1)
    per_block = n.sum(1)
    return (int(n.shape[0] * n.shape[2]), int(n.sum()), int(per_block.max()),
            int(1 + loads.max()))


def form_rounds(streams, caps, woff=None):
    """The rounds that csrc/probe_async.cuh's form_round makes of one
    block's streams, lane by lane as its producer warp does (``caps``: its
    constants, from ``probe_round_caps``).  Raw (``woff`` None):
    ``streams[j] = (lo, hi)``, positions; packed: ``(b0, b1, w0, w1)``, the
    blocks to decode and their words, ``woff[kind]`` the twin's word
    offsets, stream j of kind j % len(woff).  Returns ``(rounds, staged)``:
    the rounds on the block's chain and the positions it stages (raw:
    postings; packed: 128 a decoded block)."""
    _, raw_cap, word_cap, dec_blks, max_seg, max_open = caps
    n, j, cur, rounds, staged = len(streams), 0, None, 0, 0
    while True:
        rounds += 1
        start = wstart = nseg = 0
        stop, resume = None, None
        n_mine = min(max_open, n - j)
        for lane in range(n_mine):
            s = streams[j + lane]
            wend = 0
            if woff is None:
                lo, hi = (cur if lane == 0 and cur is not None else s[0]), s[1]
                left, lead = max(hi - lo, 0), lo & 3
                size = min((lead + left + 3) & ~3, raw_cap) if left else 0
                room = raw_cap - start - lead if start < raw_cap - lead else 0
                take = min(left, room)
                start += size
            else:
                cb, cw = cur if lane == 0 and cur is not None else (s[0], s[2])
                left, lead = max(s[1] - cb + 1, 0), cw & 3
                size = min(left, dec_blks)
                nw = ((s[3] + 3) & ~3) - (cw - lead) if left else 0
                if start >= dec_blks or wstart >= word_cap:
                    take = 0
                elif start + left <= dec_blks and wstart + nw <= word_cap:
                    take, wend = left, s[3]
                else:   # cut where the words surely fit: 128 a block at most
                    take = min(left, dec_blks - start,
                               (word_cap - wstart - lead) // 128)
                    if take > 0:
                        wend = int(woff[(j + lane) % len(woff)][cb + take])
                start += size
                wstart += min(nw, word_cap)
            if take > 0 and nseg == max_seg:
                take = 0
            nseg += take > 0
            staged += take if woff is None else 128 * take
            if left and take < left and stop is None:
                stop = lane
                resume = (lo + take if woff is None
                          else (cb + take, wend if take else cw))
        nj = j + (stop if stop is not None else n_mine)
        if nj >= n:
            return rounds, staged
        j, cur = nj, resume


def chain_before_table(items, tbounds, packed=False):
    """The first design of the work-list joins K6 and K7: one block of 256
    threads a (query, driver tile) group, walking its rows in turn, each
    row's main (and delta) tile staged synchronously, one load and two
    barriers a tile (packed: its blocks decoded, two passes of eight
    blocks, a descriptor and a word load each).  ``items`` [N, 8] are the
    table's live rows, ``tbounds`` the bounds of each kind (main, delta)
    [Q, T, 2].  Returns ``(blocks, staged, busiest, longest)``: postings
    staged (packed: decoded) in all and by the busiest block, and the most
    dependent loads on one block's chain (the group's head and row, the
    driver, then the tiles)."""
    group = np.cumsum(items[:, 4] & 1) - 1
    n_groups = int(group[-1]) + 1 if items.size else 0
    staged = np.zeros(n_groups, np.int64)
    loads = np.zeros(n_groups, np.int64)
    for kind, b in enumerate(tbounds):
        tile = items[:, 3 + 2 * kind].astype(np.int64)
        on = tile >= 0
        bq = b[items[on, 0], items[on, 2]].astype(np.int64)
        lo = np.maximum(tile[on] * 1024, bq[:, 0])
        hi = np.maximum(np.minimum((tile[on] + 1) * 1024, bq[:, 1]), lo)
        n = hi - lo
        if packed:
            n = np.where(n > 0, ((hi - 1) // 128 - lo // 128 + 1) * 128, 0)
        np.add.at(staged, group[on], n)
        np.add.at(loads, group[on], 4 if packed else 1)
    return (n_groups, int(staged.sum()), int(staged.max(initial=0)),
            3 + int(loads.max(initial=0)))


def group_kinds(wl):
    """``(most rows, dead-term groups, no-op groups)`` of a work list: the
    rows of its largest group, the groups of one TERM_START|TERM_END row
    with no tile, and the groups with no term run."""
    it = wl.desc[:wl.n_items].astype(np.int64)
    heads = wl.group_heads().astype(np.int64)
    size = np.diff(heads)
    first = it[heads[:-1]]
    starts = np.add.reduceat(((it[:, 4] & 2) != 0).astype(np.int64), heads[:-1])
    dead = (size == 1) & ((first[:, 4] & 6) == 6) & (first[:, 3] < 0) & (first[:, 5] < 0)
    return int(size.max()), int(dead.sum()), int((starts == 0).sum())


def chain_after(rlo, rhi, docs, keep, *, caps, fences=None, widths=None,
                present=None):
    """csrc/probe_async.cuh's staging, per block of ``caps[0]`` driver
    slots: raw, every planned range whole, the copies issued with the plan;
    packed, each range first narrowed to the blocks that can hold the
    block's live docIDs [smin, smax] (on their first docIDs ``fences[kind]``;
    ``widths[kind]`` the blocks' bit widths), and nothing when no slot is
    live; then the rounds (``form_rounds``).  ``docs``/``keep`` [Q, W]: the
    driver and its live slots.  Returns ``(blocks, staged, busiest,
    longest_rounds, narrowing_passes)``: postings staged (packed: decoded)
    in all and by the busiest block, the most rounds on one block, and the
    most 64-block narrowing passes on one block.  With ``present`` [Q, A]
    (a work list's groups) only the blocks of present (query, tile) pairs
    run."""
    q_n, s_n, num_a = rlo.shape
    sub = caps[0]
    nsub = 1024 // sub
    w = num_a * 1024
    d = np.full((q_n, w), np.iinfo(np.int32).max, np.int64)
    k = np.zeros((q_n, w), bool)
    d[:, :docs.shape[1]] = docs
    k[:, :keep.shape[1]] = keep
    d, k = d.reshape(q_n, num_a * nsub, sub), k.reshape(q_n, num_a * nsub, sub)
    smin = np.where(k, d, np.iinfo(np.int64).max).min(-1)
    smax = np.where(k, d, np.iinfo(np.int64).min).max(-1)
    alive = k.any(-1)
    woff = None
    if widths is not None:
        woff = [np.concatenate([[0], np.cumsum(4 * wd.astype(np.int64))])
                for wd in widths]
    total, busiest, rounds_max, passes_max, blocks = 0, 0, 0, 0, 0
    for q in range(q_n):
        for b in range(num_a * nsub):
            if present is not None and not present[q, b // nsub]:
                continue
            blocks += 1
            if widths is not None and not alive[q, b]:
                continue
            i = b // nsub
            streams, passes = [], 0
            for j in range(s_n):
                lo, hi = int(rlo[q, j, i]), int(rhi[q, j, i])
                if widths is None:
                    streams.append((lo, hi))
                    continue
                if hi <= lo:
                    streams.append((0, -1, 0, 0))
                    continue
                kind = j % len(fences)
                b0, b1 = lo >> 7, (hi - 1) >> 7
                f = fences[kind][b0:b1 + 1]
                above = np.nonzero(f > smax[q, b])[0]
                last = int(above[0]) if above.size else f.size - 1
                passes = max(passes, last // 64 + 1)
                c_lo = int((f <= smin[q, b]).sum())
                c_hi = int((f <= smax[q, b]).sum())
                if c_hi == 0:
                    streams.append((0, -1, 0, 0))
                    continue
                k0, k1 = b0 + max(c_lo - 1, 0), b0 + c_hi - 1
                streams.append((k0, k1, int(woff[kind][k0]), int(woff[kind][k1 + 1])))
            rounds, staged = form_rounds(streams, caps, woff)
            total += staged
            busiest = max(busiest, staged)
            passes_max = max(passes_max, passes)
            rounds_max = max(rounds_max, rounds)
    return blocks, total, busiest, rounds_max, passes_max


def lm_param_count(cfg) -> int:
    """A model's parameter count from its config's shapes alone: norms,
    attention or RG-LRU mixers by block kind, an MLP or an MoE FFN with its
    float32 router, the embedding, the head unless tied, the final norm."""
    d, R = cfg.d_model, cfg.lru_dim or cfg.d_model
    mlp = (3 if cfg.mlp in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    ffn = cfg.n_experts * mlp + d * cfg.n_experts if cfg.is_moe else mlp
    attn = 2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
    mixer = {"attn": attn, "local": attn, "rglru": 3 * d * R + (cfg.conv_width + 6) * R}
    pat = cfg.block_pattern
    layers = sum(mixer[pat[i % len(pat)]] + 2 * d + ffn for i in range(cfg.n_layers))
    return layers + cfg.vocab * d * (1 if cfg.tie_embeddings else 2) + d


def window_keys(S: int, W: int) -> int:
    """Keys a causal row sees under window W, summed over S rows:
    sum of min(i + 1, W)."""
    full = min(S, W)
    return full * (full + 1) // 2 + (S - full) * W


def lm_moe_hybrid(args, dev, smi: str, wrappers: dict) -> list:
    """Phase 18: K12's window against its plain version, then
    recurrentgemma-2b and Moonlight-16B-A3B at full width and depth on the
    serving path.  Returns the phase's kernel records."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import model as lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import engine as lm_engine

    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 2e-5, bf16: 2e-2}
    no_launch = {k: 0 for k in wrappers}

    def reset_launches():
        for fn in wrappers.values():
            fn.launches = 0

    def launches_now():
        return {k: fn.launches for k, fn in wrappers.items()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"[lm18] {held} bytes held by earlier phases (device memory "
        f"{torch.cuda.get_device_properties(dev).total_memory} bytes)")
    gen = torch.Generator().manual_seed(args.seed + 18)
    rng = np.random.default_rng(args.seed + 18)

    def qkv(b, s, h, kv, hd, dtype):
        return tuple(torch.randn(shape, generator=gen).to(dev, dtype)
                     for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))

    # -------------------------------------------------------------- (i)
    # K12 windowed at recurrentgemma-2b's local attention (H 10, KV 1, hd
    # 256, window 2048) and at edges, both dtypes, against the plain version
    # and the full-logits oracle
    rg_shape, rg_w = (2, 4096, 10, 1, 256), 2048
    cases = [  # (label, (B, S, H, KV, hd), window)
        ("recurrentgemma-2b local attention", rg_shape, rg_w),
        ("S = 3000, no tile multiple", (2, 3000, 10, 1, 256), rg_w),
        ("W = 37, narrower than a tile", (1, 1024, 10, 1, 256), 37),
        ("W >= S", (1, 2048, 10, 1, 256), 2048),
        ("hd 128, GQA 4, W = 300, S = 1000", (1, 1000, 8, 2, 128), 300),
        ("hd 64, W = 37, S = 640", (1, 640, 4, 2, 64), 37),
    ]
    win_err = {f32: 0.0, bf16: 0.0}
    win_bad, win_in = [], {}
    for dtype in (bf16, f32):
        for label, shape, w in cases:
            q, k, v = qkv(*shape, dtype)
            S = shape[1]
            reset_launches()
            got = fa.flash_attention_fwd_cuda(q, k, v, q_chunk=S, k_chunk=S, window=w)
            n = launches_now()
            if n != {**no_launch, "K12": 1}:
                raise AssertionError(f"K12 window {label}: launches {n}")
            ch = 512 if S % 512 == 0 else S
            errs = []
            for name, want in (
                    ("plain", fa.flash_attention_fwd_torch(q, k, v, q_chunk=ch, k_chunk=ch,
                                                           window=w)),
                    ("ref", fa.flash_attention_ref(q, k, v, window=w))):
                if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"K12 window {label}: {tuple(got.shape)} or "
                                         f"not finite")
                g, wt = got.float(), want.float()
                err = float((g - wt).abs().max())
                win_err[dtype] = max(win_err[dtype], err)
                errs.append(f"{name} {err:.3g}")
                if not torch.allclose(g, wt, rtol=tol[dtype], atol=tol[dtype]):
                    win_bad.append(f"{label} {dtype}: vs {name} {err}")
                if dtype == bf16:
                    rr = fa.max_row_rel_err(g, wt)
                    errs.append(f"row-relative {rr:.4f}")
                    if rr >= fa.BF16_ROW_REL_TOL:
                        win_bad.append(f"{label} {dtype}: row-relative vs {name} {rr}")
                del want, g, wt
            if w >= S:
                same = torch.equal(got, fa.flash_attention_fwd_cuda(q, k, v, q_chunk=S,
                                                                    k_chunk=S))
                errs.append(f"equal to the unwindowed call: {same}")
                if not same:
                    win_bad.append(f"{label} {dtype}: differs from the unwindowed call")
            log(f"[lm18] K12 window {w} {label} {shape} {str(dtype)[6:]}: max abs err "
                + ", ".join(errs) + f" (bounds rtol = atol = {tol[dtype]:g}"
                + (f", row-relative {fa.BF16_ROW_REL_TOL:g}" if dtype == bf16 else "")
                + ")")
            if label == cases[0][0]:
                win_in[dtype] = (q, k, v)
            del got
    if win_bad:
        raise AssertionError("K12 window: " + "; ".join(win_bad))

    win_rows = {}
    B_, S_, H_, KV_, hd_ = rg_shape
    pos = torch.arange(S_, device=dev)
    wmask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - rg_w)
    keys = window_keys(S_, rg_w)
    for dtype, peak in ((bf16, BF16_FLOPS_PER_S), (f32, TF32_FLOPS_PER_S / 3)):
        q, k, v = win_in[dtype]
        run = lambda: fa.flash_attention_fwd_cuda(  # noqa: E731
            q, k, v, q_chunk=S_, k_chunk=S_, window=rg_w)
        plain = lambda: fa.flash_attention_fwd_torch(  # noqa: E731
            q, k, v, q_chunk=512, k_chunk=512, window=rg_w)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=wmask, enable_gqa=True)
        sdpa_err = float((sdpa().transpose(1, 2).float() - run().float()).abs().max())
        ms = cuda_ms(run, reps=20, warmup=3)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        lib_ms = cuda_ms(sdpa, reps=10, warmup=2)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * B_ * H_ * hd_ * keys
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
        bound, by = max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
        win_rows[dtype] = (ms, plain_ms, bound, by, lib_ms)
        log(f"[times] K12 window {rg_w} {rg_shape} causal {str(dtype)[6:]}: {ms:.4f} "
            f"ms/launch (CUDA events); plain {plain_ms:.4f} ms; SDPA (boolean window "
            f"mask, enable_gqa) {lib_ms:.4f} ms (max abs diff from K12 {sdpa_err:.3g}); "
            f"bound {bound:.4f} ms ({by}: {flops} flops over {keys} keys a (b, h) "
            f"at {peak / 1e12:.0f} TFLOP/s"
            + (" (495 split three ways)" if dtype == f32 else "")
            + f", {n_bytes} bytes at 3.35 TB/s); K12 / SDPA {ms / lib_ms:.2f}x, K12 / "
            f"bound {ms / bound:.2f}x; the causal work without the window "
            f"{S_ * (S_ + 1) // 2} keys ({keys / (S_ * (S_ + 1) // 2):.3f} of it) on {smi}")
        del qt, kt, vt
    del win_in, wmask

    # the windows the models' attention hands K12 (layers._flash_gqa)
    real_k12, real_gqa = fa.flash_attention_fwd_cuda, lm_layers._flash_gqa
    k12_calls = []

    def spy_gqa(qg, *a, **kw):
        k12_calls.append((qg.shape[1], kw["window"]))
        return real_gqa(qg, *a, **kw)

    def serve(cfg, params, prompts, *, batch, max_len, new_tokens, tag):
        """Serve ``prompts`` through a ServingEngine, then the first batch
        again; per-step times and K12 launches of every prefill and decode
        step."""
        eng = lm_engine.ServingEngine(cfg, batch_size=batch, max_len=max_len, device=dev,
                                      params=params)
        steps = {"prefill": [], "decode": []}
        real = {"prefill": lm_engine.prefill, "decode": lm_engine.decode_step}

        def timed(key):
            def run(*a, **kw):
                k0 = real_k12.launches
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = real[key](*a, **kw)
                torch.cuda.synchronize()
                steps[key].append((time.perf_counter() - t, real_k12.launches - k0))
                return out
            return run

        lm_engine.prefill, lm_engine.decode_step = timed("prefill"), timed("decode")
        lm_layers._flash_gqa = spy_gqa
        try:
            for rid, prompt in enumerate(prompts):
                eng.submit(lm_engine.Request(rid=rid, prompt=prompt,
                                             max_new_tokens=new_tokens))
            torch.cuda.reset_peak_memory_stats()
            k12_calls.clear()
            reset_launches()
            t0 = time.perf_counter()
            served = []
            while eng.queue:
                served += eng.step_batch()
            t_serve = time.perf_counter() - t0
            counts, calls = launches_now(), list(k12_calls)
            peak = torch.cuda.max_memory_allocated()
            n_steps = {key: len(v) for key, v in steps.items()}
            for rid, prompt in enumerate(prompts[:batch]):
                eng.submit(lm_engine.Request(rid=100 + rid, prompt=prompt,
                                             max_new_tokens=new_tokens))
            again = eng.step_batch()
        finally:
            lm_engine.prefill, lm_engine.decode_step = real["prefill"], real["decode"]
            lm_layers._flash_gqa = real_gqa
        outs = {r.rid: r.output for r in served}
        if sorted(outs) != list(range(len(prompts))) or any(
                len(o) != new_tokens or not all(0 <= t < cfg.vocab for t in o)
                for o in outs.values()):
            raise AssertionError(f"{tag} serve: outputs {outs}")
        if any(r.output != outs[r.rid - 100] for r in again):
            raise AssertionError(f"{tag} serve: the first batch served again gave other "
                                 f"outputs")
        pre = steps["prefill"][:n_steps["prefill"]]
        dec = steps["decode"][:n_steps["decode"]]
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.block_pattern[i % len(cfg.block_pattern)] != "rglru")
        if counts != {**no_launch, "K12": len(pre) * n_attn} or any(
                n != n_attn for _, n in pre) or any(n for _, n in dec):
            raise AssertionError(f"{tag} serve: launches {counts}, per prefill "
                                 f"{[n for _, n in pre]} (expected {n_attn}), in decode "
                                 f"{sum(n for _, n in dec)}")
        plens = [max(len(p) for p in prompts[i:i + batch])
                 for i in range(0, len(prompts), batch)]
        dec_ms = [t * 1e3 for t, _ in dec]
        n_tok = sum(len(o) for o in outs.values())
        log(f"[lm18] {tag}: served {len(prompts)} requests (prompts "
            f"{[len(p) for p in prompts]}, batches of {batch} padded to {plens}) x "
            f"{new_tokens} tokens: {n_tok} tokens in {t_serve:.3f} s, "
            f"{n_tok / t_serve:.1f} tok/s; prefill "
            + ", ".join(f"{t * 1e3:.2f}" for t, _ in pre)
            + f" ms a batch (K12 {[n for _, n in pre]}); decode {np.mean(dec_ms):.3f} ms a "
            f"token (batch of {batch}; min {min(dec_ms):.3f}, max {max(dec_ms):.3f}, "
            f"{len(dec_ms)} steps, no K12); peak {peak} bytes; launches {counts['K12']} "
            f"K12, nothing else; the first batch again: equal outputs; on {smi}")
        return counts, calls, plens

    def twin_checks(cfg32, params32, tokens, tag, nodrop=None):
        """On a float32 twin: flash (K12 float32) vs naive within a
        row-relative 1e-3 at every position, and prefill of all but 8
        tokens plus 8 teacher-forced decode steps vs the forward within
        1e-3 (on ``nodrop``, a no-drop capacity copy, where given)."""
        S = tokens.shape[1]
        n_attn = sum(1 for i in range(cfg32.n_layers)
                     if cfg32.block_pattern[i % len(cfg32.block_pattern)] != "rglru")
        k12_calls.clear()
        reset_launches()
        lm_layers._flash_gqa = spy_gqa
        try:
            full = lm.forward_logits(params32, cfg32, {"tokens": tokens})
        finally:
            lm_layers._flash_gqa = real_gqa
        n = launches_now()
        naive = lm.forward_logits(params32, dataclasses.replace(cfg32, attn_impl="naive"),
                                  {"tokens": tokens})
        if launches_now() != n or n != {**no_launch, "K12": n_attn}:
            raise AssertionError(f"{tag} float32: launches {n} then {launches_now()}; "
                                 f"expected K12 = {n_attn} in the flash forward only")
        if full.shape != (tokens.shape[0], S, cfg32.vocab) or not bool(
                torch.isfinite(full).all()):
            raise AssertionError(f"{tag} float32 logits {tuple(full.shape)} or not finite")
        rr, ab = fa.max_row_rel_err(full, naive), float((full - naive).abs().max())
        del naive
        log(f"[lm18] {tag} float32 forward_logits {tuple(tokens.shape)}: flash (K12 split "
            f"TF32, {n['K12']} launches, windows {sorted(set(w for _, w in k12_calls), key=str)}) "
            f"vs naive: max abs err {ab:.4g}, row-relative {rr:.4g} (bound 1e-3, every "
            f"position)")
        if rr > 1e-3:
            raise AssertionError(f"{tag}: float32 flash vs naive row-relative {rr} > 1e-3")
        calls = list(k12_calls)
        if nodrop is not None:
            del full
            cfg32 = nodrop
            full = lm.forward_logits(params32, cfg32, {"tokens": tokens})
        last, cache = lm.prefill(params32, cfg32, {"tokens": tokens[:, :S - 8]},
                                 max_len=S)
        errs = [fa.max_row_rel_err(last, full[:, S - 9])]
        for t in range(S - 8, S):
            step, cache = lm.decode_step(params32, cfg32, tokens[:, t:t + 1], cache, t)
            errs.append(fa.max_row_rel_err(step, full[:, t]))
        log(f"[lm18] {tag} float32 prefill ({S - 8}) + 8 decode steps vs forward_logits"
            + (f" (capacity_factor {cfg32.capacity_factor}: no drops)" if nodrop else "")
            + ": row-relative " + ", ".join(f"{e:.3g}" for e in errs) + " (bound 1e-3)")
        if max(errs) > 1e-3:
            raise AssertionError(f"{tag}: prefill/decode vs forward row-relative {errs}")
        del full, cache, last, step
        return n["K12"], calls

    # -------------------------------------------------------------- (ii)
    rg_cfg = get_config("recurrentgemma-2b")
    t0 = time.perf_counter()
    rg_params = lm.init_model(rg_cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_rg = lm.count_params(rg_params)
    if n_rg != lm_param_count(rg_cfg):
        raise AssertionError(f"recurrentgemma-2b: {n_rg} parameters, not "
                             f"{lm_param_count(rg_cfg)} (full width and depth)")
    n_f32 = sum(p.numel() for p in rg_params.parameters() if p.dtype == f32)
    log(f"[lm18] {rg_cfg.name}: {rg_cfg.n_layers} layers (no depth cut; pattern "
        f"{rg_cfg.block_pattern} x 8 + (rglru, rglru)), d {rg_cfg.d_model}, H "
        f"{rg_cfg.n_heads}, KV {rg_cfg.n_kv_heads}, hd {rg_cfg.hd}, lru {rg_cfg.lru_dim}, "
        f"d_ff {rg_cfg.d_ff}, vocab {rg_cfg.vocab}, local window {rg_cfg.local_window}, "
        f"tied head; {n_rg} parameters ({n_f32} float32 gates and lam, the rest "
        f"bfloat16), init {t_init:.2f} s from seed {args.seed}")
    rg32 = dataclasses.replace(rg_cfg, param_dtype="float32", compute_dtype="float32")
    p32 = copy.deepcopy(rg_params).float()
    toks = torch.from_numpy(rng.integers(0, rg_cfg.vocab, size=(2, 3000))
                            .astype(np.int32)).to(dev)
    rg_twin, calls = twin_checks(rg32, p32, toks, "recurrentgemma-2b")
    if calls != [(3000, rg_cfg.local_window)] * 8:
        raise AssertionError(f"recurrentgemma-2b: K12 calls (S, window) {calls}")
    del p32, toks
    torch.cuda.empty_cache()
    prompts = [rng.integers(0, rg_cfg.vocab, size=int(rng.integers(2500, 4097)))
               .astype(np.int32) for _ in range(4)]
    rg_counts, calls, plens = serve(rg_cfg, rg_params, prompts, batch=2,
                                    max_len=4096 + 16, new_tokens=16,
                                    tag="recurrentgemma-2b")
    if calls != [(s, rg_cfg.local_window) for s in plens for _ in range(8)]:
        raise AssertionError(f"recurrentgemma-2b serve: K12 calls (S, window) {calls}")
    log(f"[lm18] recurrentgemma-2b serve: every K12 launch windowed ({len(calls)} at "
        f"window {rg_cfg.local_window}, S {plens})")
    del rg_params
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- (iii)
    mo_cfg = get_config("moonshot-v1-16b-a3b")
    cut = dataclasses.replace(mo_cfg, n_layers=4)
    p32 = lm.init_model(cut, seed=args.seed, device=dev).float()
    mo32 = dataclasses.replace(cut, param_dtype="float32", compute_dtype="float32")
    toks = torch.from_numpy(rng.integers(0, mo_cfg.vocab, size=(2, 1000))
                            .astype(np.int32)).to(dev)
    log(f"[lm18] {mo_cfg.name} float32 twin: cut to {cut.n_layers} of {mo_cfg.n_layers} "
        f"layers ({lm.count_params(p32)} parameters; 28 B in float32 would not fit)")
    mo_twin, _ = twin_checks(mo32, p32, toks, f"{mo_cfg.name} (4 layers)",
                             nodrop=dataclasses.replace(mo32, capacity_factor=11.0))
    del p32, toks
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mo_params = lm.init_model(mo_cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_mo = lm.count_params(mo_params)
    if n_mo != lm_param_count(mo_cfg):
        raise AssertionError(f"{mo_cfg.name}: {n_mo} parameters, not "
                             f"{lm_param_count(mo_cfg)} (full width and depth)")
    log(f"[lm18] {mo_cfg.name}: {mo_cfg.n_layers} layers (no depth cut), d "
        f"{mo_cfg.d_model}, H {mo_cfg.n_heads}, KV {mo_cfg.n_kv_heads}, hd {mo_cfg.hd}, "
        f"{mo_cfg.n_experts} experts of d_ff {mo_cfg.d_ff}, top-{mo_cfg.topk_experts}, "
        f"capacity factor {mo_cfg.capacity_factor}, vocab {mo_cfg.vocab}; {n_mo} "
        f"parameters (float32 router, the rest bfloat16; "
        f"{sum(p.numel() * p.element_size() for p in mo_params.parameters())} bytes), "
        f"init {t_init:.2f} s from seed {args.seed}; {torch.cuda.memory_allocated()} "
        f"bytes allocated now")
    routes = []
    real_route = moe_mod.route

    def spy_route(x, router, n_experts, topk, cap):
        plan = real_route(x, router, n_experts, topk, cap)
        if x.shape[1] > 1:
            routes.append((int((plan.slot_key == n_experts * cap).sum()),
                           plan.slot_key.numel(), cap))
        return plan

    prompts = [rng.integers(0, mo_cfg.vocab, size=int(rng.integers(128, 1025)))
               .astype(np.int32) for _ in range(8)]
    moe_mod.route = spy_route
    try:
        mo_counts, _, plens = serve(mo_cfg, mo_params, prompts, batch=4, max_len=1040,
                                    new_tokens=16, tag=mo_cfg.name)
    finally:
        moe_mod.route = real_route
    first = routes[:mo_cfg.n_layers]
    log(f"[lm18] {mo_cfg.name} serve: (token, slot) pairs dropped at capacity in the first "
        f"prefill (S {plens[0]}, cap {first[0][2]}): {sum(d for d, _, _ in first)} of "
        f"{sum(n for _, n, _ in first)} "
        f"({sum(d for d, _, _ in first) / sum(n for _, n, _ in first):.4f}) over "
        f"{len(first)} layers (layer 0 {first[0][0] / first[0][1]:.4f}, layer "
        f"{len(first) - 1} {first[-1][0] / first[-1][1]:.4f}: random weights route "
        f"deeper layers alike); in every prefill "
        f"{sum(d for d, _, _ in routes) / sum(n for _, n, _ in routes):.4f}")
    del mo_params
    torch.cuda.empty_cache()

    src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    return [
        {"name": f"K12 flash_attention_fwd (recurrentgemma-2b local attention, causal, "
                 f"window {rg_w}, {str(dtype)[6:]})",
         "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/flash_attention.py:136",
         "launches": launches, "max_abs_err": win_err[dtype], "ms": win_rows[dtype][0],
         "plain_ms": win_rows[dtype][1], "bound_ms": win_rows[dtype][2],
         "bound_by": win_rows[dtype][3], "library_ms": win_rows[dtype][4]}
        for dtype, launches in ((bf16, rg_counts["K12"]), (f32, rg_twin))]


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
        MergedPostingSource, StaticPostingSource, _first_k_by_rank, _pick_drivers,
        _query_windows, brute_force_topk, make_posting_source, make_query_batch,
        member_sorted, query_topk, term_window)
    from repro_torch.core.index import (
        BLOCK, INVALID_DOC, PACK_WIDTHS, TILE, InvertedIndex, build_index,
        build_sharded_index, flat_tile_pad, local_to_global_docids,
        pack_flat_postings, pack_index, unpack_flat_postings,
        unpack_flat_postings_torch)
    from repro_torch.core import calibrate as calibrate_mod
    from repro_torch.core.faults import SetHealth
    from repro_torch.core.parallel import (
        distributed_query_topk, sequential_reference, slave_topk_unmerged)
    from repro_torch.core.perfmodel import (
        QUERY_MIX_DEFAULT, SINGLE_10_ONLY, OdysPerfModel, engine_cluster, per_day)
    from repro_torch.core.queries import WorkloadConfig, generate_workload
    from repro_torch.data.corpus import (
        CorpusConfig, Mutation, MutationConfig, corpus_from_docs, generate_corpus,
        generate_mutations)
    from repro_torch.indexing.compaction import compact
    from repro_torch.indexing.delta import DeltaFullError, DeltaWriter, ShardedDeltaWriter
    from repro_torch.kernels import _build
    from repro_torch.kernels import delta_merge as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import posting_intersect as pi
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_merge as tm
    from repro_torch.kernels import worklist as wlm
    from repro_torch.obs.__main__ import REQUIRED_FAMILIES
    from repro_torch.obs.__main__ import main as obs_main
    from repro_torch.obs.exposition import dump_json, to_prometheus
    from repro_torch.obs.registry import MetricsRegistry, set_registry
    from repro_torch.obs.residual import ModelResidualMonitor
    from repro_torch.obs.trace import PHASES
    from repro_torch.serving.search import SearchService
    from repro_torch.configs import get_config
    from repro_torch.models import model as lm
    from repro_torch.serving import engine as lm_engine

    wrappers = {"K1": pi.driver_streamed_join_cuda, "K2": tm.merge_topk_rows_cuda,
                "K3": dm.merge_delta_windows_cuda, "K4": pi.streamed_join_cuda,
                "K1p": pi.driver_streamed_join_packed_cuda,
                "K3p": dm.merge_delta_windows_packed_cuda,
                "K4p": pi.streamed_join_packed_cuda,
                "K6": pi.driver_compact_join_cuda,
                "K6p": pi.driver_compact_join_packed_cuda,
                "K7": pi.streamed_compact_join_cuda,
                "K7p": pi.streamed_compact_join_packed_cuda,
                "K8": dm.merge_compact_cuda, "K8p": dm.merge_compact_packed_cuda,
                "K9": pi.batched_block_skip_join_cuda, "K10": pi.block_skip_join_cuda,
                "K11": tm.bitonic_sort_cuda, "K12": fa.flash_attention_fwd_cuda}
    no_launch = {k: 0 for k in wrappers}

    def reset_launches():
        for fn in wrappers.values():
            fn.launches = 0

    def launches_now():
        return {k: fn.launches for k, fn in wrappers.items()}

    dev = torch.device("cuda", torch.cuda.current_device())
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    clock = [time.perf_counter()]

    def phase_end(name):
        now = time.perf_counter()
        log(f"[phase] {name}: {now - clock[0]:.1f} s")
        clock[0] = now
    # ------------------------------------------------------------ 1. device
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device_count {torch.cuda.device_count()}")
    phase_end("1 device")

    # ------------------------------------------------------------ 2. build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(_build.KERNELS)} kernels from {len(built)} sources in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc, sm_90a) on {smi}")
    spills = {}
    for name, b in built.items():
        info = ptxas_info(b.log)
        log(f"[build] {name}: nvcc {b.seconds:.2f} s; " + " | ".join(
            f"{fn}: {i}" for fn, i in info.items()))
        spills.update({fn: i for fn, i in info.items()
                       if re.search(r"[1-9]\d* bytes spill", i)})
    redesigned = {fn: i for name in ("topk_merge_rows", "delta_merge", "merge_compact",
                                     "staged_join", "flash_attention")
                  for fn, i in ptxas_info(built[name].log).items()
                  if "wgmma" not in fn}
    log("[build] K2, K3, K3p, K8, K8p, K9, K10, K12 float32 (this design): "
        + " | ".join(f"{fn}: {i}" for fn, i in redesigned.items()))
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    phase_end("2 build")

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
    phase_end("3 data")

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

    # K4s, K4ps, K7s, K7ps: the static modes (no delta arrays) of K4, K4p, K7, K7p
    max_err = {k: 0 for k in [*wrappers, "K4s", "K4ps", "K7s", "K7ps"]}

    def same(kernel, label, got, want, names):
        """Bit-exact or raise; records the largest absolute difference."""
        for g, w, what in zip(got, want, names):
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            max_err[kernel] = max(max_err[kernel], err)
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{kernel} {label}: {what} differs in {bad} slots")

    probe_lib = ctypes.CDLL(str(_build.build(["driver_streamed"])[
        "driver_streamed"].path))
    caps_c = (ctypes.c_int * 6)()
    probe_lib.probe_round_caps(caps_c)
    probe_caps = tuple(caps_c)   # JOIN_SUB, RAW_CAP, WORD_CAP, DEC_BLKS, MAX_SEG, MAX_OPEN

    def chain_log(key, plans, act, docs, keep, fences=None, widths=None):
        """The main-shape launch's staging from its plans on the host: the
        first design's and this one's (chain_before, chain_after)."""
        rlo, rhi = probe_streams_host(plans, act.cpu().numpy())
        b = chain_before(rlo, rhi, widths)
        a = chain_after(rlo, rhi, docs.cpu().numpy(), keep.cpu().numpy(),
                        caps=probe_caps, fences=fences, widths=widths)
        smem = probe_lib.probe_smem_bytes(rlo.shape[1], int(widths is not None))
        what = "decoded" if widths is not None else "staged"
        log(f"[chain] {key} main shape, from its plans: first design {b[0]} blocks, "
            f"{b[1]} postings {what} ({b[2]} by the busiest block), {b[3]} dependent "
            f"loads on the longest chain, {OLD_SMEM} bytes of shared memory a block; "
            f"sub-tile {probe_caps[0]}: {a[0]} blocks, {a[1]} postings {what} ({a[2]} "
            f"by the busiest block), {a[3]} rounds and {a[4]} narrowing passes on the "
            f"longest chain, {smem} bytes of dynamic shared memory a block")

    def k1_check(label, args_, window):
        got = pi.driver_streamed_join_cuda(*args_, window=window)
        torch.cuda.synchronize()
        want = pi.driver_streamed_join_torch(*args_, window=window)
        same("K1", label, got, want, ("docs", "mask"))
        return int(want[1].sum())

    main_batch = make_query_batch(queries[:MAIN_Q], t_max=MAIN_T, meta=meta,
                                  strategy="embed", device=dev)
    last_term = meta.n_terms - 1
    empty_terms: dict[int, int] = {}
    edge_batches = {}
    for s in range(NS):
        idx = sharded.shard(s)
        lens = idx.lengths
        empty = torch.nonzero(lens == 0)
        common = int(torch.argmax(lens))
        edge_q = [([last_term], None), ([common, last_term], None),
                  ([last_term, common], 1)]
        if empty.numel():
            e = int(empty[0])
            empty_terms[s] = e
            edge_q += [([e], None), ([common, e], None), ([e, common, last_term], None)]
        edge_batch = make_query_batch(edge_q, t_max=MAIN_T, meta=meta, device=dev)
        edge_batches[s] = edge_batch
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
    phase_end("4 K1")

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
        same("K2", f"{merge} k={k} {tuple(x.shape)}", (got,),
             (tm.merge_topk_rows_torch(x, k),), ("rows",))
        log(f"[K2] {merge} k={k} shape {tuple(x.shape)}: bit-exact vs plain")
    # edge rows: k past m, duplicates, INT_MIN, all-INVALID, one row
    e_rng = np.random.default_rng(args.seed)
    int_min = -(2**31)
    edge_rows = {
        "m=1 k=10": (e_rng.integers(int_min, INVALID_DOC, (5, 1)), 10),
        "m=257 k=300": (e_rng.integers(int_min, INVALID_DOC, (5, 257)), 300),
        "m=4000 k=5000": (e_rng.integers(int_min, INVALID_DOC, (5, 4000)), 5000),
        "duplicates m=257 k=10": (e_rng.integers(0, 7, (8, 257)), 10),
        "duplicates m=4000 k=1000": (e_rng.integers(0, 7, (8, 4000)), 1000),
        "INT_MIN m=100 k=50": (np.where(e_rng.random((8, 100)) < 0.3, int_min,
                                        e_rng.integers(-9, 9, (8, 100))), 50),
        "INT_MIN m=2000 k=1000": (np.where(e_rng.random((8, 2000)) < 0.3, int_min,
                                           e_rng.integers(-9, 9, (8, 2000))), 1000),
        "all-INVALID m=200 k=50": (np.full((4, 200), INVALID_DOC), 50),
        "all-INVALID m=4000 k=1000": (np.full((4, 4000), INVALID_DOC), 1000),
        "one row m=20 k=10": (e_rng.integers(int_min, INVALID_DOC, (1, 20)), 10),
        "one row m=4000 k=1000": (e_rng.integers(int_min, INVALID_DOC, (1, 4000)), 1000),
    }
    for label, (rows, k) in edge_rows.items():
        x = torch.from_numpy(rows.astype(np.int32)).to(dev)
        got = tm.merge_topk_rows_cuda(x, k)
        torch.cuda.synchronize()
        same("K2", label, (got,), (tm.merge_topk_rows_torch(x, k),), ("rows",))
    log(f"[K2] edge rows bit-exact vs plain: {', '.join(edge_rows)}")
    phase_end("5 K2")

    # ------------------------------------------------------------ 6. serve
    def serve(svc, qs, ks):
        tickets = [svc.submit(t, s, k=k) for (t, s), k in zip(qs, ks)]
        svc.drain()
        return [(t.result.docids, t.result.n_hits) for t in tickets]

    def executed_batches(svc):
        st = svc.stats()
        return st["n_batches"] - st["n_short_circuited"]

    ks = [s.k for s in specs]
    main_kw = dict(ns=NS, window=MAIN_WINDOW, t_max=MAIN_T, batch_size=MAIN_Q,
                   merge="tournament", strategy="embed")
    torch.cuda.reset_peak_memory_stats()
    svc = SearchService(sharded, meta, **main_kw)
    reset_launches()
    t0 = time.perf_counter()
    got = serve(svc, queries, ks)
    t_serve = time.perf_counter() - t0
    static_launches = launches_now()
    executed = executed_batches(svc)
    want_launch = {**no_launch, "K1": NS * executed,
                   "K2": int(math.log2(NS)) * executed}
    log(f"[serve] main path: {len(queries)} queries, {svc.stats()['n_batches']} "
        f"batches ({executed} executed, cache hits {svc.stats()['cache']['hits']}); "
        f"launches {static_launches}, implied by the batches {want_launch}; "
        f"{t_serve:.2f} s including one-time set-up")
    if static_launches != want_launch or min(static_launches["K1"],
                                             static_launches["K2"]) == 0:
        raise AssertionError(f"launch counts {static_launches} != implied {want_launch}")
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
    s_ks = [s.k for s in s_specs]
    s_got = serve(SearchService(s_idx, s_meta, **main_kw), s_q, s_ks)
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
        reset_launches()
        svc_k = SearchService(sharded, meta, **kw)
        a = serve(svc_k, queries[:64], ks[:64])
        b = serve(SearchService(sharded, meta, backend="torch", **kw),
                  queries[:64], ks[:64])
        ex = executed_batches(svc_k)
        per = int(math.log2(NS)) if kw["merge"] == "tournament" else 1
        lk = (wrappers["K1"].launches, wrappers["K2"].launches)
        if a != b or lk != (NS * ex, per * ex):
            raise AssertionError(f"serve {label}: hits equal {a == b}, "
                                 f"launches {lk} vs {(NS * ex, per * ex)}")
        log(f"[serve] {label}: 64 queries equal backend='torch'; launches "
            f"K1 {lk[0]} K2 {lk[1]} as implied by {ex} batches")
    phase_end("6 serve")

    # ------------------------------------------------------------ 7. times
    k1_args = k1_inputs(sharded.shard(0), main_batch, MAIN_WINDOW)
    d_off, d_neff, active, _, _, _, b_tile, n_b, bounds = k1_args
    k1_ms = cuda_ms(lambda: pi.driver_streamed_join_cuda(*k1_args, window=MAIN_WINDOW))
    k1_plain = cuda_ms(lambda: pi.driver_streamed_join_torch(*k1_args, window=MAIN_WINDOW),
                       reps=10, warmup=2)
    probe = probed_postings(b_tile, n_b, bounds, TILE)
    drv = int(d_neff.sum())
    small_in = sum(x.numel() * 4 for x in (d_off, d_neff, active, k1_args[3],
                                          b_tile, n_b, bounds))
    k1_bytes = small_in + drv * 8 + probe * 4 + 2 * MAIN_Q * MAIN_WINDOW * 4
    # one compare per binary-search step, per live driver posting and
    # active other term
    k1_ops = int((d_neff.long() * active.long().sum(1)).sum()) * math.ceil(
        math.log2(MAIN_WINDOW + TILE))
    k1_bound, k1_by = bound_ms(k1_bytes, k1_ops)
    log(f"[times] K1 window {MAIN_WINDOW}, Q={MAIN_Q}, T={MAIN_T}, shard 0: "
        f"{k1_ms:.4f} ms/launch, {NS} launches/batch; plain {k1_plain:.4f} ms; "
        f"bound {k1_bound:.5f} ms ({k1_bytes} bytes: driver {drv} postings, "
        f"probed {probe} postings) on {smi}")
    log(f"[times] K1 device time (profiler): kernel {device_ms(lambda: pi.driver_streamed_join_cuda(*k1_args, window=MAIN_WINDOW), kernel='K1'):.5f} ms/launch, "
        f"plain {device_ms(lambda: pi.driver_streamed_join_torch(*k1_args, window=MAIN_WINDOW)):.5f} ms on {smi}")
    idx0 = sharded.shard(0)
    n_ranges = pi.probe_staging_check(b_tile, n_b, bounds,
                                      n_postings=idx0.postings.numel())
    log(f"[chain] K1 main shape: the staging precondition holds on all {n_ranges} "
        f"planned ranges (16-byte starts and rounded ends inside the array)")
    pos = torch.arange(MAIN_WINDOW, device=dev)
    gi = (d_off[:, None].long() + pos).clamp(max=idx0.postings.numel() - 1)
    in_win = pos[None] < d_neff[:, None]
    k1_docs = torch.where(in_win, idx0.postings[gi], INVALID_DOC)
    k1_keep = in_win & (k1_docs != INVALID_DOC) & (
        (k1_args[3][:, None] < 0) | (idx0.attrs[gi] == k1_args[3][:, None]))
    chain_log("K1", [(b_tile, n_b, bounds)], active, k1_docs, k1_keep)

    k2_rows = {}
    for (merge, k), x in k2_inputs.items():
        ms = cuda_ms(lambda x=x, k=k: tm.merge_topk_rows_cuda(x, k))
        plain = cuda_ms(lambda x=x, k=k: tm.merge_topk_rows_torch(x, k))
        # the library calls: torch.sort of the padded rows (the function
        # K2 computes) and torch.topk of the rows
        padded = torch.full((x.shape[0], tm._padded_width(x.shape[1])), INVALID_DOC,
                            dtype=torch.int32, device=dev)
        padded[:, :x.shape[1]] = x
        lib = cuda_ms(lambda p=padded: torch.sort(p, dim=-1))
        topk = cuda_ms(lambda x=x, k=k: torch.topk(x, k, dim=-1, largest=False,
                                                   sorted=True))
        k2_bytes = x.numel() * 4 + x.shape[0] * k * 4
        # the function, not the network: a selection of k of m keys takes
        # about m * ceil(log2 k) compares a row
        k2_ops = x.numel() * math.ceil(math.log2(k))
        bound, by = bound_ms(k2_bytes, k2_ops)
        k2_rows[(merge, k)] = (ms, plain, lib, bound, by)
        log(f"[times] K2 {merge} k={k} {tuple(x.shape)}: {ms:.4f} ms (device "
            f"{device_ms(lambda x=x, k=k: tm.merge_topk_rows_cuda(x, k), kernel='K2'):.5f} ms, "
            f"{tm._padded_width(x.shape[1])} keys a row); plain {plain:.4f} ms (device "
            f"{device_ms(lambda x=x, k=k: tm.merge_topk_rows_torch(x, k)):.5f} ms); "
            f"torch.sort of the padded rows {lib:.4f} ms (device "
            f"{device_ms(lambda p=padded: torch.sort(p, dim=-1)):.5f} ms); "
            f"torch.topk {topk:.4f} ms (device {device_ms(lambda x=x, k=k: torch.topk(x, k, dim=-1, largest=False)):.5f} "
            f"ms); bound {bound:.6f} ms ({by}) on {smi}")

    def timed_serve(svc, label):
        """Served queries/s and per-batch times after a warm-up, cache off."""
        batch_s: list[float] = []
        inner = svc.scheduler.executor

        def timed_executor(*a):
            t = time.perf_counter()
            out = inner(*a)                 # ends in a device->host copy (sync)
            torch.cuda.synchronize()
            batch_s.append(time.perf_counter() - t)
            return out

        svc.scheduler.executor = timed_executor
        serve(svc, queries[:96], ks[:96])
        batch_s.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits = serve(svc, queries, ks)
        wall = time.perf_counter() - t0
        bs = np.array(batch_s)
        log(f"[times] {label} served: {len(queries)} queries in {wall:.4f} s = "
            f"{len(queries) / wall:.1f} queries/s; {bs.size} batches, per-batch "
            f"mean {bs.mean() * 1e3:.3f} ms, p99 {np.percentile(bs, 99) * 1e3:.3f} ms, "
            f"max {bs.max() * 1e3:.3f} ms (host clock around synchronize, cache "
            f"off) on {smi}")
        return hits

    if timed_serve(SearchService(sharded, meta, cache_size=0, **main_kw),
                   "static") != got:
        raise AssertionError("timed pass disagrees with the main-path pass")
    log(f"[times] peak device memory {torch.cuda.max_memory_allocated()} bytes "
        f"(index {sharded.nbytes()})")

    def traced(make_svc, label):
        """One pass under the live registry and torch.profiler: the
        service's phase split, the device's busy share, and the
        hand-written kernels among the device events."""
        serve(make_svc(MetricsRegistry()), queries[:96], ks[:96])
        reg = MetricsRegistry()
        svc_p = make_svc(reg)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve(svc_p, queries, ks)
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        phases = {labels["phase"]: (h.sum, h.count)
                  for name, _, _, series in reg.collect()
                  if name == "odys_phase_seconds"
                  for labels, h in series if h.count}
        batches = svc_p.stats()["n_batches"]
        log(f"[trace] {label}: {batches} batches in {traced_wall:.4f} s traced; "
            "per-batch phase means (wall, live registry): " + ", ".join(
                f"{p} {s / n * 1e3:.3f} ms" for p, (s, n) in phases.items()
                if p in ("slave_dispatch", "master_merge", "finalize")))
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kern)
        n_kern = sum(e.count for e in kern)
        if busy_us > 0:
            log(f"[trace] {label}: device busy {busy_us / 1e3:.3f} ms of "
                f"{traced_wall * 1e3:.3f} ms traced wall = "
                f"{busy_us / (traced_wall * 1e6):.4f} busy share (idle "
                f"{1 - busy_us / (traced_wall * 1e6):.4f}); {n_kern} device ops, "
                f"{n_kern / max(batches, 1):.1f} per batch; top by device time: "
                + "; ".join(f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                            for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]))
        else:
            log(f"[trace] {label}: the profiler recorded no device time: busy "
                "share not measured")
        ours = {k: [(e.count, e.self_device_time_total) for e in kern
                    if any(n in e.key for n in kernel_names(k))]
                for k in KERNEL_NAMES}
        log(f"[trace] {label}: hand-written kernels among the device events: " + "; ".join(
            f"{k} {'/'.join(kernel_names(k))} x{sum(c for c, _ in v)} "
            f"{sum(t for _, t in v) / 1e3:.3f} ms" if v else
            f"{k} {'/'.join(kernel_names(k))} not listed" for k, v in ours.items()))

    traced(lambda reg: SearchService(sharded, meta, cache_size=0, registry=reg,
                                     **main_kw), "static")
    phase_end("7 times")

    # ------------------------------------------------------------ 8. updates
    def k3_inputs(idx, delta, d_terms, window):
        src = MergedPostingSource(idx, delta)
        span = src.driver_span(d_terms, window)
        return (idx.postings, idx.attrs, span.off.contiguous(),
                span.n_eff.contiguous(), delta.postings, delta.attrs,
                delta.offsets, delta.lengths, d_terms.to(torch.int32).contiguous())

    def k3_check(label, k3, window, cap):
        got = dm.merge_delta_windows_cuda(*k3, window=window, cap=cap)
        torch.cuda.synchronize()
        want = dm.merge_delta_windows_torch(*k3, window=window, cap=cap)
        same("K3", label, got, want, ("docs", "attrs", "src"))
        return want

    def k4_inputs(label, idx, delta, batch, window, filt):
        """K3 (checked) then K4's inputs for one slave, built as the kernel
        backend builds them (driver pick on merged lengths, the main span,
        flags and the live stream from K3's output, the two probe plans)."""
        src = MergedPostingSource(idx, delta)
        _, d_terms, active = _pick_drivers(src, batch)
        active = active.to(torch.int32).contiguous()
        cap = delta.term_capacity
        k3 = k3_inputs(idx, delta, d_terms, window)
        docs, attrs, srcs = k3_check(label, k3, window, cap)
        flags = src.driver_flags(docs).contiguous()
        live = src.driver_live(docs, srcs, flags).contiguous()
        main, dplan, cap = pi.plan_streamed(
            docs, batch.terms, active, idx.offsets, idx.lengths, idx.block_max,
            delta.offsets, delta.lengths, delta.block_max)
        attr = batch.attr_filter if filt else torch.full_like(batch.attr_filter, -1)
        return k3, (docs, attrs, live, flags, active, attr.contiguous(),
                    idx.postings, *main, delta.postings, *dplan), cap

    def k4_check(label, k4, cap):
        got = pi.streamed_join_cuda(*k4, cap=cap)
        torch.cuda.synchronize()
        want = pi.streamed_join_torch(*k4, cap=cap)
        same("K4", label, (got,), (want,), ("mask",))
        return int(want.sum())

    def k3p_check(label, k3, m_twin, d_twin, window, cap):
        """K3p against its plain version and raw K3 on the same inputs."""
        pk3 = (m_twin,) + k3[1:4] + (d_twin,) + k3[5:]
        got = dm.merge_delta_windows_packed_cuda(*pk3, window=window, cap=cap)
        torch.cuda.synchronize()
        names = ("docs", "attrs", "src")
        same("K3p", label, got, dm.merge_delta_windows_packed_torch(
            *pk3, window=window, cap=cap), names)
        same("K3p", label + " vs raw K3", got, dm.merge_delta_windows_cuda(
            *k3, window=window, cap=cap), names)
        return pk3

    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin

    def merge_edges(packed):
        """K3 (with ``packed`` K3p, also against raw K3) bit-exact at the
        chunk edges of ``dm.merge_edge_inputs`` (equal docIDs at chunk
        starts, merged lengths ending before, at and inside a chunk, empty
        and full streams, an inert driver) at windows 4096, 1000, 256 and
        BIG_WINDOW, caps 256 and 384, and at BIG_WINDOW with LARGE_CAP,
        whose ranges pass the opt-in shared memory (K3 merges out of global
        memory there, K3p takes its large-cap form)."""
        shapes = [(w, c) for w in (*MOR_WINDOWS, BIG_WINDOW) for c in (TERM_CAPACITY, 384)]
        forms = [dm.chunk_fits(w, c, optin, packed=packed) for w, c in shapes]
        if not all(forms) or dm.chunk_fits(BIG_WINDOW, LARGE_CAP, optin, packed=packed):
            raise AssertionError(f"the chunk form must take {shapes} and not "
                                 f"({BIG_WINDOW}, {LARGE_CAP})")
        shapes.append((BIG_WINDOW, LARGE_CAP))
        for window, cap_ in shapes:
            raw, twins = dm.merge_edge_inputs(window, cap_, seed=args.seed, device=dev)
            label = f"chunk edges w{window} cap {cap_}"
            if packed:
                k3p_check(label, raw, twins[0], twins[1], window, cap_)
            else:
                k3_check(label, raw, window, cap_)
        return shapes

    def k4p_check(label, k4, m_twin, d_twin, cap):
        """K4p against its plain version and raw K4 on the same inputs."""
        pk4 = k4[:6] + (m_twin,) + k4[7:10] + (d_twin,) + k4[11:]
        got = pi.streamed_join_packed_cuda(*pk4, cap=cap)
        torch.cuda.synchronize()
        same("K4p", label, (got,), (pi.streamed_join_packed_torch(*pk4, cap=cap),),
             ("mask",))
        same("K4p", label + " vs raw K4", (got,), (pi.streamed_join_cuda(*k4, cap=cap),),
             ("mask",))
        return pk4

    def mor_checks(tag, index, idx_meta, batch_main, writer, extra_terms,
                   twins=None):
        """K3 and K4 against their plain versions on every slave: the
        drivers of ``batch_main`` and an edge set (hot, rare, inert, and
        per slave the terms of ``extra_terms``), windows 4096, 1000, 256.
        With ``twins`` (the slaves' packed indexes; the writer is packed)
        K3p and K4p too, against their plain versions and raw K3/K4, and
        K3p at BIG_WINDOW (the chunk form)."""
        deltas = writer.shard_deltas()
        n_cases, sums = 0, []
        for s in range(writer.ns):
            idx, delta = index.shard(s), deltas[s]
            m_twin = None if twins is None else twins[s].packed
            lens = idx.lengths
            hot, hot2 = (int(t) for t in torch.topk(lens, 2).indices)
            dhot = int(torch.argmax(delta.lengths))
            rare = int(torch.nonzero((lens > 0) & (lens <= 64))[0]) \
                if bool(((lens > 0) & (lens <= 64)).any()) else hot
            extra = extra_terms.get(s, [])
            drivers = torch.tensor([hot, hot2, dhot, rare, -1, *extra],
                                   dtype=torch.int32, device=dev)
            edge_q = [([hot], None), ([hot, rare], None), ([rare], None),
                      ([dhot], None), ([dhot, hot], 1), ([hot, hot2, dhot], None)]
            for e in extra:
                edge_q += [([e], None), ([e, hot], None), ([hot, e], None)]
            edge = make_query_batch(edge_q, t_max=MAIN_T, meta=idx_meta,
                                    device=dev)
            for window in MOR_WINDOWS:
                label = f"{tag} shard {s} w{window} edge drivers"
                k3 = k3_inputs(idx, delta, drivers, window)
                k3_check(label, k3, window, delta.term_capacity)
                if twins is not None:
                    k3p_check(label, k3, m_twin, delta.packed, window,
                              delta.term_capacity)
                for bname, batch in (("main", batch_main), ("edge", edge)):
                    for filt in (True, False):
                        label = f"{tag} shard {s} w{window} {bname} filter {filt}"
                        k3, k4, cap = k4_inputs(label, idx, delta, batch, window, filt)
                        sums.append(k4_check(label, k4, cap))
                        if twins is not None:
                            k3p_check(label, k3, m_twin, delta.packed, window, cap)
                            k4p_check(label, k4, m_twin, delta.packed, cap)
                        n_cases += 1
            if twins is not None:
                label = f"{tag} shard {s} w{BIG_WINDOW} edge drivers"
                k3p_check(label, k3_inputs(idx, delta, drivers, BIG_WINDOW),
                          m_twin, delta.packed, BIG_WINDOW, delta.term_capacity)
        which = "K3/K4 and K3p/K4p (also vs raw)" if twins is not None else "K3 and K4"
        log(f"[{tag}] {which} bit-exact vs plain on {writer.ns} slaves: "
            f"{n_cases} K4 cases (+ as many K3 merges, and edge drivers "
            f"{sorted(extra_terms.items())} with inert -1), windows "
            f"{MOR_WINDOWS}" + (f" (+ K3p at {BIG_WINDOW})" if twins is not None
                                else "") + f"; K4 mask sums {sums[:6]}...")

    def route_to_empty_lists(writer, index, avoid, n_per_shard=1):
        """Give lists that are empty in a slave's main index a delta posting
        there: an update of a doc of that slave (none in ``avoid``) to the
        term, or, for a site term, to the site.  Returns {slave: [terms]}."""
        out: dict[int, list[int]] = {}
        vocab = writer.vocab_size
        for s in range(writer.ns):
            empty = torch.nonzero(index.shard(s).lengths == 0).flatten().tolist()
            picks = empty[:n_per_shard]
            for j, e in enumerate(picks):
                gid = next(g for g in range(s + writer.ns * (7 + j), writer.n_docs,
                                            writer.ns)
                           if g not in avoid and g not in writer.delta_doc_ids)
                if e < vocab:
                    writer.update_docs([(gid, [e], None)])
                else:
                    writer.update_docs([(gid, [], e - vocab)])
                avoid.add(gid)
            if picks:
                out[s] = picks
        return out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    writer = DeltaWriter(corpus, meta, NS, term_capacity=TERM_CAPACITY,
                         doc_headroom=DOC_HEADROOM, codec="packed", device=dev)
    t_writer = time.perf_counter() - t0
    t0 = time.perf_counter()
    muts = generate_mutations(corpus, MutationConfig(
        n_ops=4000, mean_doc_len=64, p_insert=0.4, p_delete=0.3, p_update=0.3,
        seed=args.seed))
    t_muts = time.perf_counter() - t0
    touched = {m.docid for m in muts if m.docid is not None}
    log(f"[updates] DeltaWriter(term_capacity={TERM_CAPACITY}, doc_headroom="
        f"{DOC_HEADROOM}, codec='packed') over the {corpus.n_docs}-page corpus in {t_writer:.2f} s; "
        f"{len(muts)} mixed ops (p 0.4/0.3/0.3, mean doc length 64) drawn in "
        f"{t_muts:.2f} s")
    applied, mor = 0, {}
    extra_terms: dict[int, list[int]] = {}
    for fill in FILLS:
        t0 = time.perf_counter()
        while writer.posting_fill() < fill:
            if applied == len(muts):
                raise AssertionError(f"the stream ended below fill {fill}")
            writer.apply([muts[applied]])
            applied += 1
        t_apply = time.perf_counter() - t0
        t0 = time.perf_counter()
        snap = writer.device_delta()
        torch.cuda.synchronize()
        t_snap = time.perf_counter() - t0
        n_delta = int(snap.lengths.sum())
        log(f"[updates] fill {writer.posting_fill():.3f} after {applied} ops "
            f"({t_apply:.2f} s host); {len(writer.delta_doc_ids)} docs with delta "
            f"postings, {n_delta} delta postings, doc fill {writer.doc_fill():.3f}; "
            f"device_delta() snapshot {t_snap:.4f} s, {snap.nbytes()} device bytes")
        mor_checks(f"updates fill {fill}", sharded, meta, main_batch, writer,
                   extra_terms)

        reset_launches()
        svc_u = SearchService(sharded, meta, writer=writer, **main_kw)
        u_got = serve(svc_u, queries, ks)
        counts = launches_now()
        executed = executed_batches(svc_u)
        implied = {**no_launch, "K2": int(math.log2(NS)) * executed,
                   "K3": NS * executed, "K4": NS * executed}
        if counts != implied or counts["K3"] == 0:
            raise AssertionError(f"fill {fill}: launches {counts} != implied {implied}")
        u_want = serve(SearchService(sharded, meta, writer=writer, backend="torch",
                                     **main_kw), queries, ks)
        if u_got != u_want:
            bad = sum(g != w for g, w in zip(u_got, u_want))
            raise AssertionError(f"fill {fill}: {bad} hits differ from backend='torch'")
        log(f"[updates] fill {fill}: all {len(u_got)} hits equal backend='torch'; "
            f"launches {counts} as implied by {executed} executed batches; total "
            f"n_hits {sum(n for _, n in u_got)}")
        if timed_serve(SearchService(sharded, meta, writer=writer, cache_size=0,
                                     **main_kw), f"fill {fill}") != u_got:
            raise AssertionError(f"fill {fill}: timed pass disagrees")
        mor[fill] = counts

        # a cached query, then a mutation that changes its answer
        q = next(q for q, h in zip(queries, u_got) if h[0] and h[1] > 1)
        first = svc_u.search([q])[0]
        stale0 = svc_u.stats()["cache"]["stale"]
        victim = next(d for d in first.docids
                      if d not in touched and d not in writer.delta_doc_ids)
        svc_u.delete([victim])
        touched.add(victim)
        after = svc_u.search([q])[0]
        fresh = SearchService(sharded, meta, writer=writer, backend="torch",
                              **main_kw).search([q])[0]
        if svc_u.stats()["cache"]["stale"] != stale0 + 1 or after != fresh \
                or victim in after.docids or after.n_hits != first.n_hits - 1:
            raise AssertionError(f"fill {fill}: stale cache check failed")
        log(f"[updates] fill {fill}: after deleting doc {victim} the cached query "
            f"{q} was recomputed (stale {stale0} -> {stale0 + 1}); n_hits "
            f"{first.n_hits} -> {after.n_hits}, equal to backend='torch'")
        if fill == 0.0:
            extra_terms = route_to_empty_lists(writer, sharded, touched)
            log(f"[updates] lists empty in the main index given delta postings: "
                f"{sorted(extra_terms.items())}")
    log(f"[updates] K3 bit-exact vs plain at the chunk edges, (window, cap) "
        f"{merge_edges(False)}: the chunk form (8 * (m_room + d_room) = "
        f"{8 * sum(dm.chunk_rooms(BIG_WINDOW, TERM_CAPACITY, packed=False))} bytes "
        f"of shared memory at window {BIG_WINDOW} cap {TERM_CAPACITY}), unstaged "
        f"at cap {LARGE_CAP}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[updates] peak device memory with the delta attached {peak} bytes "
        f"(index {sharded.nbytes()}, delta snapshot {writer.device_delta().nbytes()})")
    phase_end("8 updates")

    # ------------------------------------------------------------ 9. small
    s_writer = DeltaWriter(small, s_meta, NS, term_capacity=384, doc_headroom=512,
                           device=dev)
    s_muts = generate_mutations(small, MutationConfig(
        n_ops=300, mean_doc_len=20, p_insert=0.4, p_delete=0.3, p_update=0.3,
        seed=args.seed))
    s_writer.apply(s_muts)
    s_touched = {m.docid for m in s_muts if m.docid is not None}
    s_extra = route_to_empty_lists(s_writer, s_idx, s_touched, n_per_shard=2)
    s_lens = s_idx.lengths.sum(0)
    tomb = int(torch.nonzero((s_lens > 0) & (s_lens <= 8))[0])
    s_mutated = s_writer.mutated_corpus()
    holders = [d for d in range(s_mutated.n_docs) if tomb in s_mutated.terms_of(d)]
    s_writer.delete_docs(holders)
    for s in range(NS):
        s_extra.setdefault(s, []).append(tomb)
    mor_checks("small cap 384", s_idx, s_meta, make_query_batch(
        s_q[:MAIN_Q], t_max=MAIN_T, meta=s_meta, device=dev), s_writer, s_extra)
    # a term with no main postings anywhere, served from the delta alone
    tiny = corpus_from_docs([np.array(d, np.int32) for d in ([0, 1], [0, 2], [1, 2])],
                            [0, 1, 0], vocab_size=8, n_sites=4)
    tiny_idx, tiny_meta = build_sharded_index(tiny, 1, device=dev)
    tiny_w = DeltaWriter(tiny, tiny_meta, 1, term_capacity=384, doc_headroom=128,
                         device=dev)
    tiny_w.insert_docs([([5, 0], 2), ([5], 1)])
    mor_checks("tiny", tiny_idx, tiny_meta, make_query_batch(
        [([5], None), ([5, 0], None), ([0, 5], 2), ([0], None)], t_max=MAIN_T,
        meta=tiny_meta, device=dev), tiny_w, {0: [5]})

    o_q = s_q + [([t], None) for t in sorted({tomb, *sum(s_extra.values(), [])})
                 if t < s_meta.vocab_size]
    o_ks = s_ks + [10] * (len(o_q) - len(s_q))
    svc_s = SearchService(s_idx, s_meta, writer=s_writer, **main_kw)
    o_got = serve(svc_s, o_q, o_ks)
    mutated = s_writer.mutated_corpus()
    o_truth = brute_force_topk(mutated, o_q, mutated.n_docs)
    o_want = [(t[:k], len(t)) for t, k in zip(o_truth, o_ks)]
    if o_got != o_want:
        bad = sum(g != w for g, w in zip(o_got, o_want))
        raise AssertionError(f"small: {bad} of {len(o_q)} differ from brute force")
    t0 = time.perf_counter()
    svc_s.compact(verify=True)
    t_small_compact = time.perf_counter() - t0
    if serve(svc_s, o_q, o_ks) != o_want:
        raise AssertionError("small: hits changed across compaction")
    log(f"[small] {len(o_q)} queries over {len(s_muts)} mixed ops, {len(holders)} "
        f"deletes tombstoning term {tomb}, and delta postings in main-empty lists "
        f"{sorted(s_extra.items())} equal brute force over the mutated corpus; "
        f"compact(verify=True) in {t_small_compact:.2f} s swapped in the folded "
        f"index and the same queries give the same hits")
    phase_end("9 small")

    # ------------------------------------------------------------ 10. mor-times
    idx0, delta0 = sharded.shard(0), writer.shard_deltas()[0]
    cap = delta0.term_capacity
    k3m, k4m, _ = k4_inputs("times", idx0, delta0, main_batch, MAIN_WINDOW, True)
    k3_ms = cuda_ms(lambda: dm.merge_delta_windows_cuda(*k3m, window=MAIN_WINDOW, cap=cap))
    k3_plain = cuda_ms(lambda: dm.merge_delta_windows_torch(
        *k3m, window=MAIN_WINDOW, cap=cap), reps=10, warmup=2)
    m_docs, _ = dm._stream(idx0.postings, idx0.attrs, k3m[2].long(), k3m[3].long(),
                           MAIN_WINDOW)
    start, d_len = dm._slab(k3m[8], delta0.offsets, delta0.lengths, cap)
    d_docs, _ = dm._stream(delta0.postings, delta0.attrs, start, d_len, cap)
    keys = torch.cat([m_docs, d_docs], dim=-1).contiguous()
    k3_lib = cuda_ms(lambda: torch.sort(keys, dim=-1, stable=True))
    na = k3m[3].long().clamp(max=MAIN_WINDOW).cpu()
    nb = d_len.cpu()
    # docID and attr of each posting that reaches the output (the first
    # `window` of the merge), five int32 per query, three outputs
    k3_read = int((na + nb).clamp(max=MAIN_WINDOW).sum())
    k3_bytes = k3_read * 8 + 5 * MAIN_Q * 4 + 3 * MAIN_Q * MAIN_WINDOW * 4
    k3_ops = int(sum(min(a + b, MAIN_WINDOW) * (math.ceil(math.log2(min(a, b) + 1)) + 1)
                     for a, b in zip(na.tolist(), nb.tolist())))
    k3_bound, k3_by = bound_ms(k3_bytes, k3_ops)
    log(f"[times] K3 window {MAIN_WINDOW}, Q={MAIN_Q}, cap {cap}, shard 0, fill "
        f"{writer.posting_fill():.3f}: {k3_ms:.4f} ms/launch, {NS} launches/batch; "
        f"plain {k3_plain:.4f} ms; torch.sort(stable) of the (Q, window+cap) keys "
        f"{k3_lib:.4f} ms; bound {k3_bound:.6f} ms ({k3_by}; {k3_bytes} bytes: "
        f"{k3_read} of main {int(na.sum())} + delta {int(nb.sum())} postings "
        f"read) on {smi}")
    log(f"[times] K3 device time (profiler): kernel {device_ms(lambda: dm.merge_delta_windows_cuda(*k3m, window=MAIN_WINDOW, cap=cap), kernel='K3'):.5f} "
        f"ms/launch, plain {device_ms(lambda: dm.merge_delta_windows_torch(*k3m, window=MAIN_WINDOW, cap=cap)):.5f} ms, "
        f"torch.sort(stable) {device_ms(lambda: torch.sort(keys, dim=-1, stable=True)):.5f} ms on {smi}")
    replay, r_stats = dm.merge_chunks_replay(*k3m, window=MAIN_WINDOW, cap=cap)
    same("K3", "main shape vs the host replay of its chunks",
         dm.merge_delta_windows_cuda(*k3m, window=MAIN_WINDOW, cap=cap),
         tuple(x.to(dev) for x in replay), ("docs", "attrs", "src"))
    log(f"[merge] K3 main shape, from the host replay of its chunks (equal to the "
        f"kernel): {r_stats['chunks']} of {MAIN_Q * -(-MAIN_WINDOW // dm.K3_CHUNK)} "
        f"chunks of {dm.K3_CHUNK} slots read postings, at most {r_stats['main']} main "
        f"+ {r_stats['delta']} delta postings staged a chunk in one round of loads")

    (a_docs, _, a_live, _, a_active, a_filter, _, mb_tile, mn_b, mbounds, _,
     db_tile, dn_b, dbounds) = k4m
    k4_ms = cuda_ms(lambda: pi.streamed_join_cuda(*k4m, cap=cap))
    k4_plain = cuda_ms(lambda: pi.streamed_join_torch(*k4m, cap=cap),
                       reps=10, warmup=2)
    probe_m = probed_postings(mb_tile, mn_b, mbounds, TILE)
    probe_d = probed_postings(db_tile, dn_b, dbounds, TILE)
    live_slots = (a_live != 0).long().sum(1)
    # What the function must read: every driver docID; the live stream of
    # valid slots; the flags of live slots of queries that join a term; the
    # attrs of valid slots of filtered queries; the probed postings; and it
    # writes the mask.
    valid = (a_docs != INVALID_DOC).long().sum(1)
    joins = a_active.long().sum(1) > 0
    k4_slots = (MAIN_Q * MAIN_WINDOW + int(valid.sum())
                + int(live_slots[joins].sum()) + int(valid[a_filter >= 0].sum()))
    k4_small = sum(x.numel() * 4 for x in (a_active, mb_tile, mn_b, mbounds, db_tile,
                                          dn_b, dbounds)) + MAIN_Q * 4
    k4_bytes = (k4_small + (k4_slots + MAIN_Q * MAIN_WINDOW) * 4
                + (probe_m + probe_d) * 4)
    k4_ops = int((live_slots * a_active.long().sum(1)).sum()) * (
        math.ceil(math.log2(MAIN_WINDOW + TILE)) + math.ceil(math.log2(cap + TILE)))
    k4_bound, k4_by = bound_ms(k4_bytes, k4_ops)
    log(f"[times] K4 window {MAIN_WINDOW}, Q={MAIN_Q}, T={MAIN_T}, cap {cap}, "
        f"shard 0: {k4_ms:.4f} ms/launch, {NS} launches/batch; plain "
        f"{k4_plain:.4f} ms; bound {k4_bound:.6f} ms ({k4_by}; {k4_bytes} bytes: "
        f"{int(valid.sum())} valid and {int(live_slots.sum())} live driver slots, "
        f"probed main {probe_m} + delta {probe_d} postings) on {smi}")
    log(f"[times] K4 device time (profiler): kernel "
        f"{device_ms(lambda: pi.streamed_join_cuda(*k4m, cap=cap), kernel='K4'):.5f} ms/launch, "
        f"plain {device_ms(lambda: pi.streamed_join_torch(*k4m, cap=cap)):.5f} ms on {smi}")
    n_ranges = (pi.probe_staging_check(mb_tile, mn_b, mbounds,
                                       n_postings=idx0.postings.numel())
                + pi.probe_staging_check(db_tile, dn_b, dbounds,
                                         n_postings=delta0.postings.numel()))
    log(f"[chain] K4 main shape: the staging precondition holds on all {n_ranges} "
        f"planned main and delta ranges")
    k4_keep = (a_docs != INVALID_DOC) & (a_live != 0) & (
        (a_filter[:, None] < 0) | (k4m[1] == a_filter[:, None]))
    chain_log("K4", [(mb_tile, mn_b, mbounds), (db_tile, dn_b, dbounds)], a_active,
              a_docs, k4_keep)

    traced(lambda reg: SearchService(sharded, meta, writer=writer, cache_size=0,
                                     registry=reg, **main_kw), "fill 1.0")

    # compaction of the full-size delta: fold, rebuild, swap; the compacted
    # index serves equal to backend="torch" (a rebuild is not the oracle
    # here: the lists are far longer than the window)
    svc_c = SearchService(sharded, meta, writer=writer, **main_kw)
    t0 = time.perf_counter()
    svc_c.compact()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    reset_launches()
    c_got = serve(svc_c, queries[:128], ks[:128])
    c_counts = launches_now()
    c_ex = executed_batches(svc_c)
    c_want = serve(SearchService(svc_c.index, svc_c.meta, writer=writer,
                                 backend="torch", **main_kw), queries[:128], ks[:128])
    if c_got != c_want or c_counts["K3"] != NS * c_ex or c_counts["K1"] != 0:
        raise AssertionError(f"compacted index: hits equal {c_got == c_want}, "
                             f"launches {c_counts}")
    log(f"[compact] full-size compaction (fold {writer.base_corpus.n_docs} pages, "
        f"rebuild, swap) in {t_compact:.2f} s; 128 queries on the compacted index "
        f"equal backend='torch', launches {c_counts}; index "
        f"{svc_c.index.nbytes()} device bytes")
    phase_end("10 mor-times")

    # ------------------------------------------------------------ 11. packed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twins = [pack_index(sharded.shard(s)) for s in range(NS)]
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    hist_all = np.zeros(64, np.int64)
    meta_host = []
    for s, tw in enumerate(twins):
        pk = tw.packed
        m_host = pk.blk_meta[:pk.n_blocks].cpu().numpy()
        meta_host.append(m_host)
        hist = np.bincount(m_host & 63, minlength=64)
        hist_all += hist
        if not torch.equal(unpack_flat_postings_torch(pk), tw.postings):
            raise AssertionError(f"packed: slave {s}'s decode differs from its postings")
        raw_b = tw.postings.numel() * tw.postings.element_size()
        words_b = pk.words.numel() * 4
        log(f"[packed] slave {s}: raw postings {raw_b} bytes, packed {pk.nbytes()} "
            f"bytes (words {words_b}, descriptors {pk.nbytes() - words_b}), raw/packed "
            f"{raw_b / pk.nbytes():.3f}, raw/live postings "
            f"{int(tw.lengths.sum()) * 4 / pk.nbytes():.3f}; {pk.n_blocks} blocks, "
            f"chunk_rows {pk.chunk_rows}; blocks by width "
            + ", ".join(f"{w}: {hist[w]}" for w in PACK_WIDTHS))
    # a 32-bit gap needs more than 2**16 pages on a slave (a short rehearsal
    # has fewer); width 0 holds every block of at most one posting
    need = (0, 32) if corpus.n_docs // NS > 1 << 16 else (0,)
    if any(hist_all[w] == 0 for w in need) or hist_all.sum() != sum(
            hist_all[w] for w in PACK_WIDTHS):
        raise AssertionError(f"packed: widths {np.nonzero(hist_all)[0].tolist()}, "
                             f"need {need}")
    t0 = time.perf_counter()
    host_twin = pack_flat_postings(sharded.shard(0).postings.cpu())
    t_host_pack = time.perf_counter() - t0
    if host_twin.chunk_rows != twins[0].packed.chunk_rows or not all(
            torch.equal(a, b.cpu()) for a, b in zip(host_twin.arrays(),
                                                    twins[0].packed.arrays())):
        raise AssertionError("packed: slave 0's device pack differs from its CPU pack")
    log(f"[packed] pack_index of {NS} slaves on the card in {t_pack:.3f} s; every "
        f"decode equals its raw postings; widths {need} occur (widths 0 and 32: "
        f"{hist_all[0]} and {hist_all[32]} blocks); slave 0 packed on the host in {t_host_pack:.2f} s "
        f"equals its device pack array for array")

    def k1p_check(label, idx_p, batch, window, filt=True):
        """K1p against its plain version and raw K1 on the same inputs."""
        a = k1_inputs(idx_p, batch, window, filt)
        pa = a[:4] + (idx_p.packed,) + a[5:]
        got = pi.driver_streamed_join_packed_cuda(*pa, window=window)
        torch.cuda.synchronize()
        same("K1p", label, got, pi.driver_streamed_join_packed_torch(*pa, window=window),
             ("docs", "mask"))
        same("K1p", label + " vs raw K1", got, pi.driver_streamed_join_cuda(*a, window=window),
             ("docs", "mask"))
        return got, pa

    for s in range(NS):
        for label, batch, window, filt in (
            ("main filter-on", main_batch, MAIN_WINDOW, True),
            ("main filter-off", main_batch, MAIN_WINDOW, False),
            ("window 1000", main_batch, 1000, True),
            ("window 1536", main_batch, 1536, True),
            ("empty+last lists", edge_batches[s], MAIN_WINDOW, True),
            ("empty+last lists w1000", edge_batches[s], 1000, True),
        ):
            k1p_check(f"shard {s} {label}", twins[s], batch, window, filt)
    aux_p = pack_index(aux_idx)
    for window in (128, 1000, 1024, 1536):
        k1p_check(f"array-edge index window {window}", aux_p, aux_batch, window)
    log(f"[packed] K1p bit-exact vs its plain version and raw K1 on {NS} slaves x 6 "
        f"cases (phase 4's) and on the array-edge index at windows 128, 1000, 1024, 1536")

    # a synthetic array of every width: two blocks a width, gaps at the top of
    # their range (a width-16 field sets its word's sign bit), width 32 from a
    # gap of 2**29, and a last block of one posting (width 0, no word)
    rng = np.random.default_rng(args.seed)
    gap_blocks = []
    for _ in range(2):
        for w in PACK_WIDTHS:
            if w == 0:
                g = np.zeros(BLOCK, np.int64)
            elif w == 32:
                g = rng.integers(0, 1 << 16, BLOCK)
                g[5] = (1 << 29) + 7
            else:
                g = rng.integers(0, 1 << w, BLOCK)
                g[1:9:2] = (1 << w) - 1
            g[0] = rng.integers(1, 1000)
            gap_blocks.append(g)
    gap_blocks.append(np.array([5]))
    syn_docs = np.cumsum(np.concatenate(gap_blocks)).astype(np.int32)
    n_syn = syn_docs.size
    syn_flat = np.full(flat_tile_pad(n_syn), INVALID_DOC, np.int32)
    syn_flat[:n_syn] = syn_docs
    flat_t = torch.from_numpy(syn_flat).to(dev)
    n_lists = -(-n_syn // BLOCK)
    offs = torch.arange(n_lists, dtype=torch.int32, device=dev) * BLOCK
    syn_idx = pack_index(InvertedIndex(
        offsets=offs, lengths=(n_syn - offs).to(torch.int32), postings=flat_t,
        attrs=torch.where(flat_t != INVALID_DOC, 0, -1).to(torch.int32),
        block_max=flat_t.view(-1, BLOCK).amax(1).contiguous(),
        doc_site=torch.zeros(BLOCK, dtype=torch.int32, device=dev)))
    syn_meta = syn_idx.packed.blk_meta[:syn_idx.packed.n_blocks].cpu().numpy()
    host_decode = unpack_flat_postings(syn_idx.packed)
    if not np.array_equal(host_decode, syn_flat) or set(
            (syn_meta[:n_lists] & 63).tolist()) != set(PACK_WIDTHS):
        raise AssertionError("packed: the synthetic array does not hold every width")
    syn_q = ([([k], None) for k in range(n_lists)]
             + [([k, (k + 5) % n_lists], None) for k in range(n_lists)]
             + [([0, n_lists - 1, 3], None)])
    syn_batch = make_query_batch(syn_q, t_max=MAIN_T, device=dev)
    for window in (2048, 1000, 128):
        (docs_k, _), _ = k1p_check(f"synthetic window {window}", syn_idx, syn_batch, window)
        docs_h = docs_k.cpu().numpy()
        for k in range(n_lists):
            n_k = min(n_syn - k * BLOCK, window)
            if not np.array_equal(docs_h[k, :n_k], host_decode[k * BLOCK:k * BLOCK + n_k]):
                raise AssertionError(f"packed: synthetic list {k} window {window} "
                                     "differs from the numpy decode")
    log(f"[packed] synthetic array ({n_syn} postings, blocks of every width incl. a "
        f"sign-bit word and a final width-0 block): K1p equals the numpy decode, its "
        f"plain version and raw K1 at windows 2048, 1000, 128")

    # merge-on-read: a packed writer replaying phase 8's stream
    p_writer = DeltaWriter(corpus, meta, NS, term_capacity=TERM_CAPACITY,
                           doc_headroom=DOC_HEADROOM, codec="packed", device=dev)
    p_touched = {m.docid for m in muts if m.docid is not None}
    applied_p, p_extra, pack_s, p_views = 0, {}, [], {}
    for fill in FILLS:
        while p_writer.posting_fill() < fill:
            p_writer.apply([muts[applied_p]])
            applied_p += 1
        t0 = time.perf_counter()
        p_writer.device_delta()
        torch.cuda.synchronize()
        t_raw = time.perf_counter() - t0
        t0 = time.perf_counter()
        views = p_views[fill] = p_writer.shard_deltas()
        torch.cuda.synchronize()
        t_twins = time.perf_counter() - t0
        pack_s.append(t_twins)
        d_raw = sum(v.postings.numel() * 4 for v in views)
        d_packed = sum(v.packed.nbytes() for v in views)
        log(f"[packed] writer fill {p_writer.posting_fill():.3f} after {applied_p} ops: "
            f"raw snapshot {t_raw:.4f} s, then the {NS} slab twins of this version "
            f"{t_twins:.4f} s (delta raw {d_raw} bytes, packed {d_packed} bytes)")
        mor_checks(f"packed fill {fill}", sharded, meta, main_batch, p_writer,
                   p_extra, twins=twins)
        if fill == 0.0:
            p_extra = route_to_empty_lists(p_writer, sharded, p_touched)
    log(f"[packed] K3p bit-exact vs plain and raw K3 at the chunk edges, (window, "
        f"cap) {merge_edges(True)}: the chunk form at window {BIG_WINDOW} cap "
        f"{TERM_CAPACITY} ({8 * sum(dm.chunk_rooms(BIG_WINDOW, TERM_CAPACITY, packed=True))} "
        f"bytes of shared memory a block, no scratch), the large-cap form at cap "
        f"{LARGE_CAP} ({8 * sum(dm.chunk_rooms(BIG_WINDOW, LARGE_CAP, packed=True))} "
        f"bytes > {optin})")

    # the packed path end to end, every raw posting array zeroed
    k_all = max(ks)
    batches = [make_query_batch(queries[i:i + MAIN_Q], t_max=MAIN_T, meta=meta,
                                strategy="embed", device=dev)
               for i in range(0, len(queries), MAIN_Q)]
    raw_shards = [sharded.shard(s) for s in range(NS)]
    blind = [tw._replace(postings=torch.zeros_like(tw.postings)) for tw in twins]
    p_deltas = p_writer.shard_deltas()
    blind_deltas = [d._replace(postings=torch.zeros_like(d.postings)) for d in p_deltas]

    def as_hits(results, kk):
        out = []
        for r in results:
            rows, hits = r.docids.cpu().numpy(), r.n_hits.cpu().numpy()
            out += [([int(d) for d in row if d != INVALID_DOC], int(h))
                    for row, h in zip(rows, hits)]
        return [(d[:k], h) for (d, h), k in zip(out, kk)]

    def packed_path(label, deltas_blind, deltas_raw, implied, served):
        """The main path of this phase: every batch through the packed
        kernels, launch counts per batch, then held against the plain raw
        path and the raw service's hits."""
        reset_launches()
        results = []
        for b in batches:
            before = launches_now()
            results.append(sequential_reference(
                blind, b, ns=NS, k=k_all, window=MAIN_WINDOW, deltas=deltas_blind,
                backend="kernel", codec="packed"))
            per = {k: v - before[k] for k, v in launches_now().items()}
            if per != {**no_launch, **implied}:
                raise AssertionError(f"packed {label}: launches per batch {per}")
        counts = launches_now()
        torch.cuda.synchronize()
        for b, r in zip(batches, results):
            w = sequential_reference(raw_shards, b, ns=NS, k=k_all, window=MAIN_WINDOW,
                                     deltas=deltas_raw, backend="torch", codec="raw")
            if not (torch.equal(r.docids, w.docids) and torch.equal(r.n_hits, w.n_hits)):
                raise AssertionError(f"packed {label}: differs from backend='torch', raw")
        if as_hits(results, ks) != served:
            raise AssertionError(f"packed {label}: differs from the raw service")
        log(f"[packed] {label}: {len(queries)} queries in {len(batches)} batches through "
            f"sequential_reference(codec='packed', backend='kernel') with every raw "
            f"posting zeroed equal backend='torch', codec='raw' and the raw service; "
            f"launches {counts}, per batch {implied}; total n_hits "
            f"{sum(h for _, h in served)}")
        return counts

    p_static = packed_path("static", None, None, {"K1p": NS}, got)
    p_served = serve(SearchService(sharded, meta, writer=p_writer, **main_kw), queries, ks)
    p_mor = packed_path("fill 1.0", blind_deltas, p_deltas, {"K3p": NS, "K4p": NS},
                        p_served)

    # the 3000-page corpus, packed writer of term capacity 384
    sp_writer = DeltaWriter(small, s_meta, NS, term_capacity=384, doc_headroom=512,
                            codec="packed", device=dev)
    sp_writer.apply(s_muts)
    sp_extra = route_to_empty_lists(sp_writer, s_idx, {m.docid for m in s_muts
                                                       if m.docid is not None},
                                    n_per_shard=2)
    sp_before = sp_writer.mutated_corpus()
    sp_holders = [d for d in range(sp_before.n_docs) if tomb in sp_before.terms_of(d)]
    sp_writer.delete_docs(sp_holders)
    for s in range(NS):
        sp_extra.setdefault(s, []).append(tomb)
    s_twins = [pack_index(s_idx.shard(s)) for s in range(NS)]
    mor_checks("packed small cap 384", s_idx, s_meta, make_query_batch(
        s_q[:MAIN_Q], t_max=MAIN_T, meta=s_meta, device=dev), sp_writer, sp_extra,
        twins=s_twins)
    sp_q = s_q + [([t], None) for t in sorted({tomb, *sum(sp_extra.values(), [])})
                  if t < s_meta.vocab_size]
    sp_ks = s_ks + [10] * (len(sp_q) - len(s_q))
    sp_batch = make_query_batch(sp_q, t_max=MAIN_T, meta=s_meta, device=dev)
    sp_mutated = sp_writer.mutated_corpus()
    sp_want = [(t[:k], len(t)) for t, k in zip(
        brute_force_topk(sp_mutated, sp_q, sp_mutated.n_docs), sp_ks)]

    def small_packed(shards_):
        r = sequential_reference(shards_, sp_batch, ns=NS, k=max(sp_ks), window=MAIN_WINDOW,
                                 deltas=sp_writer.shard_deltas(), backend="kernel",
                                 codec="packed")
        return as_hits([r], sp_ks)

    if small_packed(s_twins) != sp_want:
        raise AssertionError("packed small: differs from brute force")
    sp_index, _ = compact(sp_writer, verify=True)
    if small_packed([pack_index(sp_index.shard(s)) for s in range(NS)]) != sp_want:
        raise AssertionError("packed small: differs from brute force after compaction")
    log(f"[packed] small: {len(sp_q)} queries through the packed path equal brute "
        f"force over the mutated corpus, before and after compact(verify=True) and "
        f"pack_index")

    # times, slave 0, main-path shapes; fill 1.0 for K3p/K4p
    (_, _), k1p_args = k1p_check("times", twins[0], main_batch, MAIN_WINDOW)
    d_off, d_neff, active, _, _, _, b_tile, n_b, bounds = k1p_args
    k1p_run = lambda: pi.driver_streamed_join_packed_cuda(*k1p_args, window=MAIN_WINDOW)
    k1p_plain_run = lambda: pi.driver_streamed_join_packed_torch(*k1p_args, window=MAIN_WINDOW)
    k1p_ms = cuda_ms(k1p_run)
    k1p_plain = cuda_ms(k1p_plain_run, reps=10, warmup=2)
    k1p_dev, k1p_plain_dev = device_ms(k1p_run, kernel="K1p"), device_ms(k1p_plain_run)
    drv_b, drv_blk = span_block_cost(d_off, d_neff, meta_host[0])
    prb_b, prb_blk = probe_block_cost(b_tile, n_b, bounds, TILE, meta_host[0])
    drv = int(d_neff.sum())
    small_in = sum(x.numel() * 4 for x in (d_off, d_neff, active, k1p_args[3],
                                          b_tile, n_b, bounds))
    k1p_bytes = small_in + drv_b + prb_b + drv * 4 + 2 * MAIN_Q * MAIN_WINDOW * 4
    # K1's binary-search compares plus four operations (shift, mask, add,
    # scan step) per decoded posting
    k1p_ops = int((d_neff.long() * active.long().sum(1)).sum()) * math.ceil(
        math.log2(MAIN_WINDOW + TILE)) + 4 * BLOCK * (drv_blk + prb_blk)
    k1p_bound, k1p_by = bound_ms(k1p_bytes, k1p_ops)
    log(f"[times] K1p window {MAIN_WINDOW}, Q={MAIN_Q}, T={MAIN_T}, shard 0: "
        f"{k1p_ms:.4f} ms/launch (device {k1p_dev:.5f} ms), {NS} launches/batch; plain "
        f"{k1p_plain:.4f} ms (device {k1p_plain_dev:.5f} ms); bound {k1p_bound:.6f} ms "
        f"({k1p_by}; {k1p_bytes} bytes: driver {drv_blk} blocks {drv_b} bytes, probes "
        f"{prb_blk} blocks {prb_b} bytes, {drv} attrs) on {smi}")
    pk0 = twins[0].packed
    n_ranges = pi.probe_staging_check(b_tile, n_b, bounds, packed=pk0)
    log(f"[chain] K1p main shape: the staging precondition holds on all {n_ranges} "
        f"planned ranges (their blocks' words 16-byte aligned inside the words)")
    p_fences = [pk0.blk_base[:pk0.n_blocks].long().cpu().numpy()]
    chain_log("K1p", [(b_tile, n_b, bounds)], active, k1_docs, k1_keep, p_fences,
              [meta_host[0] & 63])

    pd0 = p_deltas[0]
    cap = pd0.term_capacity
    k3m, k4m, _ = k4_inputs("times packed", twins[0], pd0, main_batch, MAIN_WINDOW, True)
    pk3 = k3p_check("times", k3m, twins[0].packed, pd0.packed, MAIN_WINDOW, cap)
    pk4 = k4p_check("times", k4m, twins[0].packed, pd0.packed, cap)
    k3p_run = lambda: dm.merge_delta_windows_packed_cuda(*pk3, window=MAIN_WINDOW, cap=cap)
    k3p_plain_run = lambda: dm.merge_delta_windows_packed_torch(*pk3, window=MAIN_WINDOW,
                                                                cap=cap)
    k3p_ms = cuda_ms(k3p_run)
    k3p_plain = cuda_ms(k3p_plain_run, reps=10, warmup=2)
    k3p_dev, k3p_plain_dev = device_ms(k3p_run, kernel="K3p"), device_ms(k3p_plain_run)
    d_meta_host = pd0.packed.blk_meta[:pd0.packed.n_blocks].cpu().numpy()
    na = k3m[3].long().clamp(max=MAIN_WINDOW)
    start, d_len = dm._slab(k3m[8], pd0.offsets, pd0.lengths, cap)
    m_b, m_blk = span_block_cost(k3m[2], na, meta_host[0])
    dd_b, dd_blk = span_block_cost(start, d_len, d_meta_host)
    k3p_read = int((na + d_len).clamp(max=MAIN_WINDOW).sum())
    k3p_bytes = (m_b + dd_b + k3p_read * 4 + 5 * MAIN_Q * 4
                 + 3 * MAIN_Q * MAIN_WINDOW * 4)
    k3p_ops = int(sum(min(a + b, MAIN_WINDOW) * (math.ceil(math.log2(min(a, b) + 1)) + 1)
                      for a, b in zip(na.tolist(), d_len.tolist()))) + 4 * BLOCK * (
        m_blk + dd_blk)
    k3p_bound, k3p_by = bound_ms(k3p_bytes, k3p_ops)
    log(f"[times] K3p window {MAIN_WINDOW}, Q={MAIN_Q}, cap {cap}, shard 0, fill "
        f"{p_writer.posting_fill():.3f}: {k3p_ms:.4f} ms/launch (device {k3p_dev:.5f} "
        f"ms), {NS} launches/batch; plain {k3p_plain:.4f} ms (device "
        f"{k3p_plain_dev:.5f} ms); bound {k3p_bound:.6f} ms ({k3p_by}; {k3p_bytes} "
        f"bytes: main {m_blk} blocks {m_b} bytes, delta {dd_blk} blocks {dd_b} bytes, "
        f"{k3p_read} attrs) on {smi}")
    dec = (unpack_flat_postings_torch(pk3[0]),) + pk3[1:4] + (
        unpack_flat_postings_torch(pk3[4]),) + pk3[5:]
    replay, r_stats = dm.merge_chunks_replay(*dec, window=MAIN_WINDOW, cap=cap,
                                             packed=True)
    same("K3p", "main shape vs the host replay of its chunks", k3p_run(),
         tuple(x.to(dev) for x in replay), ("docs", "attrs", "src"))
    log(f"[merge] K3p main shape, from the host replay of its chunks (equal to the "
        f"kernel): {r_stats['chunks']} chunks of {dm.K3P_CHUNK} slots read postings, "
        f"{r_stats['blocks']} blocks decoded in all, at most {r_stats['main_blocks']} "
        f"main + {r_stats['delta_blocks']} delta a chunk")

    (a_docs, _, a_live, _, a_active, a_filter, _, mb_tile, mn_b, mbounds, _,
     db_tile, dn_b, dbounds) = pk4
    k4p_run = lambda: pi.streamed_join_packed_cuda(*pk4, cap=cap)
    k4p_plain_run = lambda: pi.streamed_join_packed_torch(*pk4, cap=cap)
    k4p_ms = cuda_ms(k4p_run)
    k4p_plain = cuda_ms(k4p_plain_run, reps=10, warmup=2)
    k4p_dev, k4p_plain_dev = device_ms(k4p_run, kernel="K4p"), device_ms(k4p_plain_run)
    pm_b, pm_blk = probe_block_cost(mb_tile, mn_b, mbounds, TILE, meta_host[0])
    pdd_b, pdd_blk = probe_block_cost(db_tile, dn_b, dbounds, TILE, d_meta_host)
    live_slots = (a_live != 0).long().sum(1)
    valid = (a_docs != INVALID_DOC).long().sum(1)
    joins = a_active.long().sum(1) > 0
    k4p_slots = (MAIN_Q * MAIN_WINDOW + int(valid.sum())
                 + int(live_slots[joins].sum()) + int(valid[a_filter >= 0].sum()))
    k4p_small = sum(x.numel() * 4 for x in (a_active, mb_tile, mn_b, mbounds, db_tile,
                                           dn_b, dbounds)) + MAIN_Q * 4
    k4p_bytes = k4p_small + (k4p_slots + MAIN_Q * MAIN_WINDOW) * 4 + pm_b + pdd_b
    k4p_ops = int((live_slots * a_active.long().sum(1)).sum()) * (
        math.ceil(math.log2(MAIN_WINDOW + TILE)) + math.ceil(math.log2(cap + TILE))
    ) + 4 * BLOCK * (pm_blk + pdd_blk)
    k4p_bound, k4p_by = bound_ms(k4p_bytes, k4p_ops)
    log(f"[times] K4p window {MAIN_WINDOW}, Q={MAIN_Q}, T={MAIN_T}, cap {cap}, shard 0: "
        f"{k4p_ms:.4f} ms/launch (device {k4p_dev:.5f} ms), {NS} launches/batch; plain "
        f"{k4p_plain:.4f} ms (device {k4p_plain_dev:.5f} ms); bound {k4p_bound:.6f} ms "
        f"({k4p_by}; {k4p_bytes} bytes: probes main {pm_blk} blocks {pm_b} bytes + "
        f"delta {pdd_blk} blocks {pdd_b} bytes) on {smi}")
    n_ranges = (pi.probe_staging_check(mb_tile, mn_b, mbounds, packed=pk0)
                + pi.probe_staging_check(db_tile, dn_b, dbounds, packed=pd0.packed))
    log(f"[chain] K4p main shape: the staging precondition holds on all {n_ranges} "
        f"planned main and delta ranges")
    pk4_keep = (a_docs != INVALID_DOC) & (a_live != 0) & (
        (a_filter[:, None] < 0) | (pk4[1] == a_filter[:, None]))
    chain_log("K4p", [(mb_tile, mn_b, mbounds), (db_tile, dn_b, dbounds)], a_active,
              a_docs, pk4_keep,
              p_fences + [pd0.packed.blk_base[:pd0.packed.n_blocks].long().cpu().numpy()],
              [meta_host[0] & 63, d_meta_host & 63])

    def seq_batch_ms(shards_, deltas_, codec):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in batches:
            sequential_reference(shards_, b, ns=NS, k=k_all, window=MAIN_WINDOW,
                                 deltas=deltas_, backend="kernel", codec=codec)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / len(batches) * 1e3

    for label, dl in (("static", None), ("fill 1.0", p_deltas)):
        seq_batch_ms(raw_shards, dl, "raw")
        seq_batch_ms(twins, dl, "packed")
        order = ("raw", "packed", "packed", "raw")
        ms = [seq_batch_ms(raw_shards if c == "raw" else twins, dl, c) for c in order]
        log(f"[times] sequential_reference(backend='kernel') {label}, per batch of "
            f"{MAIN_Q} (ms, host clock around synchronize, in turns "
            f"{'/'.join(order)}): " + " / ".join(f"{x:.3f}" for x in ms)
            + f" on {smi}")
    log(f"[packed] seconds per packed shard_deltas() version (the twins on top of the "
        f"raw snapshot): " + ", ".join(f"{x:.4f}" for x in pack_s))
    phase_end("11 packed")

    # ------------------------------------------------------------ 12. compact
    def live_cases(batch):
        """The live_q patterns of one batch: all live; the last rows inert
        as clones of the last live query (12 of 32, as the scheduler pads a
        partial bucket); one live query; every other query live."""
        q_n = batch.terms.shape[0]
        n_live = q_n - 12 if q_n > 12 else max(1, q_n // 2)
        pick = torch.tensor(list(range(n_live)) + [n_live - 1] * (q_n - n_live),
                            device=dev)
        clones = type(batch)(*(x[pick].contiguous() for x in batch))
        return [("all live", batch, None),
                (f"last {q_n - n_live} inert clones", clones, np.arange(q_n) < n_live),
                ("one live", batch, np.eye(q_n, dtype=bool)[q_n // 2]),
                ("alternate", batch, np.arange(q_n) % 2 == 0)]

    def live_mask(live, q_n):
        return (torch.ones(q_n, dtype=torch.bool, device=dev) if live is None
                else torch.from_numpy(live).to(dev))

    def held(kernel, label, got, dense, live, inert, names):
        """A compact kernel's live rows equal the dense kernel's; its inert
        rows hold the inert values."""
        rows = live_mask(live, got[0].shape[0])
        same(kernel, label + " vs dense", [g[rows] for g in got],
             [d[rows] for d in dense], names)
        for g, v, what in zip(got, inert, names):
            if not bool((g[~rows] == v).all()):
                raise AssertionError(f"{kernel} {label}: inert rows of {what} "
                                     f"are not {v}")

    def no_launch_when_inert(label, fn):
        before = launches_now()
        out = fn()
        if launches_now() != before:
            raise AssertionError(f"{label}: an all-inert batch launched "
                                 f"{ {k: v - before[k] for k, v in launches_now().items()} }")
        return out

    def k6_cases(label, idx_p, batch, window, filt):
        """K6 and K6p (idx_p carries both codecs) against their plain
        versions and K1 / K1p on the live rows, under every live_q pattern;
        the all-inert batch launches nothing."""
        for pname, b, live in live_cases(batch):
            a = k1_inputs(idx_p, b, window, filt)
            wl, bounds = pi.plan_driver_compact(
                a[0], a[1], b.terms, a[2], idx_p.offsets, idx_p.lengths,
                idx_p.block_max, window=window, live_q=live)
            if live is None:
                wl_all = wl
            desc, heads = wlm.table_to_device(wl, dev)
            for kname, src, cuda_fn, plain_fn, dense in (
                ("K6", idx_p.postings, pi.driver_compact_join_cuda,
                 pi.driver_compact_join_torch,
                 lambda: pi.driver_streamed_join_cuda(*a, window=window)),
                ("K6p", idx_p.packed, pi.driver_compact_join_packed_cuda,
                 pi.driver_compact_join_packed_torch,
                 lambda: pi.driver_streamed_join_packed_cuda(
                     *a[:4], idx_p.packed, *a[5:], window=window))):
                args = (desc, heads, a[0], a[1], a[3], src, a[5], bounds)
                got = cuda_fn(*args, window=window)
                torch.cuda.synchronize()
                ctx = f"{label} {pname}"
                same(kname, ctx, got, plain_fn(*args, window=window), ("docs", "mask"))
                held(kname, ctx, got, dense(), live, (INVALID_DOC, 0), ("docs", "mask"))
        a = k1_inputs(idx_p, batch, window, filt)
        for packed in (None, idx_p.packed):
            d, m = no_launch_when_inert(label, lambda: ops.intersect_fullstream_compact(
                a[0], a[1], batch.terms, a[2], a[3], idx_p.postings, idx_p.attrs,
                idx_p.offsets, idx_p.lengths, idx_p.block_max, window=window,
                packed=packed, live_q=np.zeros(batch.terms.shape[0], bool)))
            if not (bool((d == INVALID_DOC).all()) and bool((m == 0).all())):
                raise AssertionError(f"{label}: all-inert rows are not (INVALID_DOC, 0)")
        return wl_all

    def k8_cases(label, idx_p, delta, k3, window, patterns):
        """K8 and K8p against their plain versions and K3 / K3p on the live
        rows of K3's inputs ``k3``, under each (name, live_q) of
        ``patterns``; all-inert launches nothing."""
        cap = delta.term_capacity
        pk3 = (idx_p.packed,) + k3[1:4] + (delta.packed,) + k3[5:]
        q_n = k3[8].shape[0]
        dense = {"K8": dm.merge_delta_windows_cuda(*k3, window=window, cap=cap),
                 "K8p": dm.merge_delta_windows_packed_cuda(*pk3, window=window, cap=cap)}
        names = ("docs", "attrs", "src")
        for pname, live in patterns:
            wl = dm.plan_merge_compact(k3[3], window=window, live_q=live)
            desc, heads = wlm.table_to_device(wl, dev)
            for kname, args, cuda_fn, plain_fn in (
                ("K8", k3, dm.merge_compact_cuda, dm.merge_compact_torch),
                ("K8p", pk3, dm.merge_compact_packed_cuda, dm.merge_compact_packed_torch)):
                got = cuda_fn(desc, heads, *args, window=window, cap=cap)
                torch.cuda.synchronize()
                ctx = f"{label} {pname}"
                same(kname, ctx, got, plain_fn(desc, heads, *args, window=window,
                                               cap=cap), names)
                held(kname, ctx, got, dense[kname], live, (INVALID_DOC, -1, 1), names)
        for packed, d_packed in ((None, None), (idx_p.packed, delta.packed)):
            out = no_launch_when_inert(label, lambda: ops.merge_windows_compact(
                *k3[:8], delta.block_max, k3[8], window=window, packed=packed,
                d_packed=d_packed, live_q=np.zeros(q_n, bool)))
            if not all(bool((o == v).all()) for o, v in zip(out, (INVALID_DOC, -1, 1))):
                raise AssertionError(f"{label}: all-inert merge rows are not inert")

    def k7_cases(label, idx_p, delta, batch, window, filt, with_k8=True):
        """K8 on each batch's drivers (``with_k8``), then K7 and K7p against
        their plain versions and K4 / K4p on the live rows, under every
        live_q pattern; all-inert launches nothing.  Returns the all-live
        table."""
        names = ("mask",)
        for pname, b, live in live_cases(batch):
            ctx = f"{label} {pname}"
            k3, k4, cap = k4_inputs(ctx, idx_p, delta, b, window, filt)
            if with_k8:
                k8_cases(ctx + " K8", idx_p, delta, k3, window, [(pname, live)])
            wl, bounds, d_bounds = pi.plan_streamed_compact(
                k4[0], b.terms, k4[4], idx_p.offsets, idx_p.lengths,
                idx_p.block_max, delta.offsets, delta.lengths, delta.block_max,
                live_q=live)
            if live is None:
                wl_all = wl
            desc, heads = wlm.table_to_device(wl, dev)
            pk4 = k4[:6] + (idx_p.packed,) + k4[7:10] + (delta.packed,) + k4[11:]
            for kname, m_src, d_src, cuda_fn, plain_fn, dense in (
                ("K7", idx_p.postings, delta.postings, pi.streamed_compact_join_cuda,
                 pi.streamed_compact_join_torch,
                 lambda: pi.streamed_join_cuda(*k4, cap=cap)),
                ("K7p", idx_p.packed, delta.packed, pi.streamed_compact_join_packed_cuda,
                 pi.streamed_compact_join_packed_torch,
                 lambda: pi.streamed_join_packed_cuda(*pk4, cap=cap))):
                args = (desc, heads, *k4[:4], k4[5], m_src, bounds, d_src, d_bounds)
                got = (cuda_fn(*args),)
                torch.cuda.synchronize()
                same(kname, ctx, got, (plain_fn(*args),), names)
                held(kname, ctx, got, (dense(),), live, (0,), names)
            if pname == "all live":
                for packed, d_packed in ((None, None), (idx_p.packed, delta.packed)):
                    m = no_launch_when_inert(ctx, lambda: ops.intersect_streamed_compact(
                        *k4[:3], b.terms, k4[4], k4[5], idx_p.postings,
                        idx_p.offsets, idx_p.lengths, idx_p.block_max,
                        delta.postings, delta.offsets, delta.lengths,
                        delta.block_max, k4[3], packed=packed, d_packed=d_packed,
                        live_q=np.zeros(b.terms.shape[0], bool)))
                    if not bool((m == 0).all()):
                        raise AssertionError(f"{ctx}: all-inert mask rows are not 0")
        return wl_all

    def k7_lockstep_cases(label, idx_p, delta, batch, window):
        """K7 and K7p over tables whose runs are longer in one kind than the
        other: K4's plans compiled again with two more tiles in each run of
        delta tiles (the delta tiles outlast the main ones, rows with main
        tile -1) and, separately, of main tiles.  The added tiles follow the
        last planned one, so they hold no docID of the driver tile: bit-exact
        against the plain versions (which execute the same table) and K4 /
        K4p.  Returns the rows where one kind goes on past the other."""
        k3, k4, cap = k4_inputs(label, idx_p, delta, batch, window, True)
        a_any, main, dplan, _ = pi._streamed_plans(
            k4[0], batch.terms, k4[4], idx_p.offsets, idx_p.lengths,
            idx_p.block_max, delta.offsets, delta.lengths, delta.block_max)
        act_h, nb_h, bt_h, any_h, nd_h, dt_h = wlm.plan_to_host(
            k4[4], main[1], main[0], a_any, dplan[1], dplan[0])
        pk4 = k4[:6] + (idx_p.packed,) + k4[7:10] + (delta.packed,) + k4[11:]
        dense = {"K7": pi.streamed_join_cuda(*k4, cap=cap),
                 "K7p": pi.streamed_join_packed_cuda(*pk4, cap=cap)}
        past = {}
        for name, nb2, nd2, col in (
                ("delta tiles outlast main", nb_h, nd_h + 2 * (nd_h > 0), 5),
                ("main tiles outlast delta", nb_h + 2 * (nb_h > 0), nd_h, 3)):
            wl = wlm.build_intersect_worklist(nb2, bt_h, act_h, any_h, n_d=nd2,
                                              d_tile=dt_h, kernel="lockstep check",
                                              dense_steps=1)
            it = wl.desc[:wl.n_items].astype(np.int64)
            run = np.cumsum((it[:, 4] & 2) != 0)   # 0: rows before any run
            other = 8 - col
            has_other = np.zeros(run.max() + 1, bool)
            np.logical_or.at(has_other, run, it[:, other] >= 0)
            past[name] = int(((it[:, col] >= 0) & (it[:, other] < 0)
                              & has_other[run]).sum())
            desc, heads = wlm.table_to_device(wl, dev)
            for kname, m_src, d_src, cuda_fn, plain_fn in (
                ("K7", idx_p.postings, delta.postings, pi.streamed_compact_join_cuda,
                 pi.streamed_compact_join_torch),
                ("K7p", idx_p.packed, delta.packed, pi.streamed_compact_join_packed_cuda,
                 pi.streamed_compact_join_packed_torch)):
                args = (desc, heads, *k4[:4], k4[5], m_src, main[2], d_src, dplan[2])
                got = (cuda_fn(*args),)
                torch.cuda.synchronize()
                ctx = f"{label} {name}"
                same(kname, ctx, got, (plain_fn(*args),), ("mask",))
                held(kname, ctx, got, (dense[kname],), None, (0,), ("mask",))
        return past

    def big_batch(s):
        """Queries whose groups at window BIG_WINDOW pass 32 rows: a driver
        of about 8192 postings against the hottest lists' windows, whose
        1024-posting tiles it spans by the dozen; its tiles past those
        windows give dead-term groups, its tiles past its own postings and a
        one-term query no-op groups."""
        lens = twins[s].lengths.long()
        hot, hot2 = (int(t) for t in torch.topk(lens, 2).indices)
        mid = int(torch.argmin((lens - 8192).abs()))
        return make_query_batch([([mid, hot], None), ([mid], None),
                                 ([hot, mid, hot2], None), ([mid, hot2], 1)],
                                t_max=MAIN_T, meta=meta, device=dev)

    for s in range(NS):
        for label, batch, window, filt in (
            ("main filter-on", main_batch, MAIN_WINDOW, True),
            ("main filter-off", main_batch, MAIN_WINDOW, False),
            ("window 1000", main_batch, 1000, True),
            ("window 1536", main_batch, 1536, True),
            ("empty+last lists", edge_batches[s], MAIN_WINDOW, True),
            ("empty+last lists w1000", edge_batches[s], 1000, True),
        ):
            k6_cases(f"compact shard {s} {label}", twins[s], batch, window, filt)
    for window in (128, 1000, 1024, 1536):
        k6_cases(f"compact array-edge index window {window}", aux_p, aux_batch, window,
                 True)
    full_size = corpus.n_docs // NS >= 1 << 19
    big_kinds = [group_kinds(k6_cases(f"compact shard {s} window {BIG_WINDOW}", twins[s],
                                      big_batch(s), BIG_WINDOW, True))
                 for s in range(NS)]
    most, n_dead, n_noop = (max(k[0] for k in big_kinds), sum(k[1] for k in big_kinds),
                            sum(k[2] for k in big_kinds))
    # (a short rehearsal's slaves hold lists too short for groups that long)
    if full_size and (most <= 32 or n_dead == 0 or n_noop == 0):
        raise AssertionError(f"window {BIG_WINDOW}: groups of up to {most} rows, "
                             f"{n_dead} dead-term and {n_noop} no-op groups; the case "
                             "needs groups past 32 rows and both special groups")
    log(f"[compact] window {BIG_WINDOW}: K6 and K6p bit-exact likewise on {NS} slaves' "
        f"[mid, hot], [mid], [hot, mid, hot2], [mid, hot2] site 1 (mid: the list "
        f"nearest 8192 postings), every live_q pattern: groups of up to {most} rows, "
        f"{n_dead} dead-term and {n_noop} no-op groups (all live)")
    log(f"[compact] K6 and K6p bit-exact vs their plain versions and, on live rows, "
        f"vs K1 / K1p on {NS} slaves x 6 cases (phase 4's) and the array-edge index, "
        f"under live_q all live / last rows inert clones / one live / alternate; "
        f"all-inert batches launched nothing")

    lockstep, big7 = {}, []
    for fill in FILLS:
        views = p_views[fill]
        for s in range(NS):
            idx_p, delta = twins[s], views[s]
            lens = idx_p.lengths
            hot, hot2 = (int(t) for t in torch.topk(lens, 2).indices)
            dhot = int(torch.argmax(delta.lengths))
            rare = int(torch.nonzero((lens > 0) & (lens <= 64))[0]) \
                if bool(((lens > 0) & (lens <= 64)).any()) else hot
            extra = p_extra.get(s, [])
            drivers = torch.tensor([hot, hot2, dhot, rare, -1, *extra],
                                   dtype=torch.int32, device=dev)
            edge_q = [([hot], None), ([hot, rare], None), ([rare], None),
                      ([dhot], None), ([dhot, hot], 1), ([hot, hot2, dhot], None)]
            for e in extra:
                edge_q += [([e], None), ([e, hot], None), ([hot, e], None)]
            edge = make_query_batch(edge_q, t_max=MAIN_T, meta=meta, device=dev)
            for window in MOR_WINDOWS:
                tag = f"compact fill {fill} shard {s} w{window}"
                n_drv = drivers.shape[0]
                k8_cases(tag + " edge drivers", idx_p, delta,
                         k3_inputs(idx_p, delta, drivers, window), window,
                         [("all live", None),
                          ("one live", np.eye(n_drv, dtype=bool)[n_drv // 2]),
                          ("alternate", np.arange(n_drv) % 2 == 0),
                          ("first half", np.arange(n_drv) < max(1, n_drv // 2))])
                for bname, batch in (("main", main_batch), ("edge", edge)):
                    for filt in (True, False):
                        k7_cases(f"{tag} {bname} filter {filt}", idx_p, delta, batch,
                                 window, filt)
                if fill == 1.0 and window != 256:
                    for bname, batch in (("main", main_batch), ("edge", edge)):
                        for name, n in k7_lockstep_cases(f"{tag} {bname}", idx_p, delta,
                                                         batch, window).items():
                            lockstep[name] = lockstep.get(name, 0) + n
            if fill == 1.0:
                wl_big = k7_cases(f"compact fill {fill} shard {s} w{BIG_WINDOW}",
                                  idx_p, delta, big_batch(s), BIG_WINDOW, True,
                                  with_k8=False)
                big7.append(group_kinds(wl_big))
        log(f"[compact] fill {fill}: K8/K8p and K7/K7p bit-exact vs their plain "
            f"versions and, on live rows, vs K3/K3p and K4/K4p on {NS} slaves (phase "
            f"8's cases: main and edge drivers incl. inert -1 and main-empty lists "
            f"{sorted(p_extra.items())}, filter on/off, windows {MOR_WINDOWS}), every "
            f"live_q pattern; all-inert batches launched nothing")
    def k8_edges():
        """K8 and K8p at the chunk edges of ``dm.merge_edge_inputs`` through a
        work list (windows 4096, 1000, 256 and BIG_WINDOW, caps 256 and 384,
        and BIG_WINDOW at LARGE_CAP, where K8 merges out of global memory
        and K8p takes its large-cap form), under every live_q pattern:
        bit-exact against their plain versions and, on live rows, K3 / K3p.
        The profiler's trace names the form K8p launched at each shape: its
        chunk kernel wherever ``chunk_fits``, its row kernel elsewhere."""
        shapes = [(w, c) for w in (*MOR_WINDOWS, BIG_WINDOW) for c in (TERM_CAPACITY, 384)]
        shapes.append((BIG_WINDOW, LARGE_CAP))
        names = ("docs", "attrs", "src")
        forms, n = {}, 0
        for window, cap_ in shapes:
            raw, tw = dm.merge_edge_inputs(window, cap_, seed=args.seed, device=dev)
            pk = (tw[0],) + raw[1:4] + (tw[1],) + raw[5:]
            q_n = raw[8].shape[0]
            dense = {"K8": dm.merge_delta_windows_cuda(*raw, window=window, cap=cap_),
                     "K8p": dm.merge_delta_windows_packed_cuda(*pk, window=window,
                                                               cap=cap_)}
            for pname, live in (("all live", None),
                                ("one live", np.eye(q_n, dtype=bool)[q_n // 2]),
                                ("alternate", np.arange(q_n) % 2 == 0)):
                wl = dm.plan_merge_compact(raw[3], window=window, live_q=live)
                desc, heads = wlm.table_to_device(wl, dev)
                for kname, a_, cuda_fn, plain_fn in (
                    ("K8", raw, dm.merge_compact_cuda, dm.merge_compact_torch),
                    ("K8p", pk, dm.merge_compact_packed_cuda,
                     dm.merge_compact_packed_torch)):
                    got = cuda_fn(desc, heads, *a_, window=window, cap=cap_)
                    torch.cuda.synchronize()
                    ctx = f"chunk edges w{window} cap {cap_} {pname}"
                    same(kname, ctx, got, plain_fn(desc, heads, *a_, window=window,
                                                   cap=cap_), names)
                    held(kname, ctx, got, dense[kname], live, (INVALID_DOC, -1, 1),
                         names)
                    n += 1
                if live is None:
                    got_forms = launched_forms(lambda: dm.merge_compact_packed_cuda(
                        desc, heads, *pk, window=window, cap=cap_), "K8p")
                    want = ("merge_compact_packed_kernel"
                            if dm.chunk_fits(window, cap_, optin, packed=True)
                            else "merge_compact_packed_row_kernel")
                    if got_forms != {want}:
                        raise AssertionError(f"K8p at window {window}, cap {cap_}: "
                                             f"launched {got_forms}, expected {want}")
                    forms[(window, cap_)] = want
        log(f"[compact] K8 and K8p at the chunk edges of merge_edge_inputs through a "
            f"work list: {n} launches bit-exact vs their plain versions and, on live "
            f"rows, vs K3 / K3p, at (window, cap) {shapes}, live_q all / one / "
            f"alternate; K8p's form from the profiler's trace: "
            + ", ".join(f"{w}/{c} {f}" for (w, c), f in forms.items()))

    k8_edges()
    if min(lockstep.values()) == 0 or (full_size and max(k[0] for k in big7) <= 32):
        raise AssertionError(f"lockstep rows {lockstep}, K7 groups at window "
                             f"{BIG_WINDOW}: {big7}")
    log(f"[compact] fill 1.0: K7/K7p bit-exact likewise over tables whose runs are "
        f"longer in one kind (main and edge drivers, windows 4096 and 1000, {NS} "
        f"slaves; rows where one kind goes on past the other: {lockstep}) and at "
        f"window {BIG_WINDOW} on big_batch (groups of up to "
        f"{max(k[0] for k in big7)} rows, {sum(k[1] for k in big7)} dead-term and "
        f"{sum(k[2] for k in big7)} no-op groups)")

    # the path: 512 queries, 16 batches of 32, through sequential_reference
    def compact_path(label, shards_, deltas_, codec, implied, dense_shards):
        reset_launches()
        results = []
        for b in batches:
            before = launches_now()
            results.append(sequential_reference(
                shards_, b, ns=NS, k=k_all, window=MAIN_WINDOW, deltas=deltas_,
                backend="kernel_compact", codec=codec))
            per = {k: v - before[k] for k, v in launches_now().items()}
            if per != {**no_launch, **implied}:
                raise AssertionError(f"compact {label}: launches per batch {per}")
        counts = launches_now()
        torch.cuda.synchronize()
        raw_deltas = None if deltas_ is None else p_views[1.0]
        for b, r in zip(batches, results):
            for backend, sh, dl, cd in (("kernel", dense_shards, deltas_, codec),
                                        ("torch", raw_shards, raw_deltas, "raw")):
                w = sequential_reference(sh, b, ns=NS, k=k_all, window=MAIN_WINDOW,
                                         deltas=dl, backend=backend, codec=cd)
                if not (torch.equal(r.docids, w.docids) and torch.equal(r.n_hits, w.n_hits)):
                    raise AssertionError(f"compact {label}: differs from backend={backend!r}")
        log(f"[compact] {label}: {len(queries)} queries in {len(batches)} batches through "
            f"sequential_reference(backend='kernel_compact', codec={codec!r}) equal "
            f"backend='kernel' and backend='torch'; launches {counts}, per batch {implied}")
        return counts

    c_static = compact_path("static raw", raw_shards, None, "raw", {"K6": NS}, raw_shards)
    c_static_p = compact_path("static packed, raw postings zeroed", blind, None, "packed",
                              {"K6p": NS}, twins)
    c_mor = compact_path("fill 1.0 raw", raw_shards, p_views[1.0], "raw",
                         {"K8": NS, "K7": NS}, raw_shards)
    c_mor_p = compact_path("fill 1.0 packed, raw postings zeroed", blind, blind_deltas,
                           "packed", {"K8p": NS, "K7p": NS}, twins)

    # the 3000-page corpus: brute force before and after compact(verify=True)
    sc_writer = DeltaWriter(small, s_meta, NS, term_capacity=384, doc_headroom=512,
                            codec="packed", device=dev)
    sc_writer.apply(s_muts)
    route_to_empty_lists(sc_writer, s_idx, {m.docid for m in s_muts
                                            if m.docid is not None}, n_per_shard=2)
    sc_before = sc_writer.mutated_corpus()
    sc_writer.delete_docs([d for d in range(sc_before.n_docs)
                           if tomb in sc_before.terms_of(d)])
    sc_mutated = sc_writer.mutated_corpus()
    sc_want = [(t[:k], len(t)) for t, k in zip(
        brute_force_topk(sc_mutated, sp_q, sc_mutated.n_docs), sp_ks)]

    def small_compact(shards_):
        for codec in ("raw", "packed"):
            r = sequential_reference(shards_, sp_batch, ns=NS, k=max(sp_ks),
                                     window=MAIN_WINDOW, deltas=sc_writer.shard_deltas(),
                                     backend="kernel_compact", codec=codec)
            if as_hits([r], sp_ks) != sc_want:
                raise AssertionError(f"compact small ({codec}): differs from brute force")

    small_compact(s_twins)
    sc_index, _ = compact(sc_writer, verify=True)
    small_compact([pack_index(sc_index.shard(s)) for s in range(NS)])
    log(f"[compact] small: {len(sp_q)} queries through backend='kernel_compact' (raw "
        f"and packed) equal brute force over the mutated corpus, before and after "
        f"compact(verify=True)")

    # times, slave 0, main-path shapes (all live); fill 1.0 for K8/K7
    t_idx = twins[0]
    ka = k1_inputs(t_idx, main_batch, MAIN_WINDOW)
    host_s = {}

    def timed_plan(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        desc, heads = wlm.table_to_device(out[0] if isinstance(out, tuple) else out, dev)
        torch.cuda.synchronize()
        host_s.setdefault(name, []).append(time.perf_counter() - t)
        return out, desc, heads

    for _ in range(10):
        (wl6, bounds6), desc6, heads6 = timed_plan("K6", lambda: pi.plan_driver_compact(
            ka[0], ka[1], main_batch.terms, ka[2], t_idx.offsets, t_idx.lengths,
            t_idx.block_max, window=MAIN_WINDOW))
    d1 = p_views[1.0][0]
    cap = d1.term_capacity
    k3m, k4m, _ = k4_inputs("compact times", t_idx, d1, main_batch, MAIN_WINDOW, True)
    for _ in range(10):
        wl8, desc8, heads8 = timed_plan("K8", lambda: dm.plan_merge_compact(
            k3m[3], window=MAIN_WINDOW))
        (wl7, bounds7, dbounds7), desc7, heads7 = timed_plan(
            "K7", lambda: pi.plan_streamed_compact(
                k4m[0], main_batch.terms, k4m[4], t_idx.offsets, t_idx.lengths,
                t_idx.block_max, d1.offsets, d1.lengths, d1.block_max))
    _, b6_tile, n6_b, _ = pi._driver_plan(
        ka[0], ka[1], main_batch.terms, ka[2], t_idx.offsets, t_idx.lengths,
        t_idx.block_max, window=MAIN_WINDOW)
    plan_h = wlm.plan_to_host(n6_b, b6_tile, ka[2])
    a_any_h = np.ones((MAIN_Q, -(-MAIN_WINDOW // TILE)), bool)
    t0 = time.perf_counter()
    for _ in range(10):
        wlm.build_intersect_worklist(*plan_h, a_any_h, kernel="build timing",
                                     dense_steps=1)
    t_build = (time.perf_counter() - t0) / 10
    log(f"[times] compact host work per call (device plan, one device->host copy, "
        f"numpy build, one host->device copy; slave 0, Q={MAIN_Q}, mean of 10): "
        + ", ".join(f"{k} {np.mean(v) * 1e3:.3f} ms (min {np.min(v) * 1e3:.3f})"
                    for k, v in host_s.items())
        + f"; the K6 numpy build alone {t_build * 1e3:.3f} ms; tables of {wl6.n_items} "
        f"/ {wl8.n_items} / {wl7.n_items} rows (K6 / K8 / K7) on {smi}")

    def groups_of(wl):
        heads = wl.group_heads()
        first = wl.desc[heads[:-1]]
        return first[:, 0].astype(np.int64), first[:, 1].astype(np.int64), heads

    def table_small(wl, n_groups):
        return 32 * wl.n_items + 4 * (n_groups + 1)

    compact_rows = {}

    def time_compact(kname, cuda_run, plain_run, n_bytes, n_ops, extra, lib=None):
        ms, plain = cuda_ms(cuda_run), cuda_ms(plain_run, reps=10, warmup=2)
        dev_ms, plain_dev = device_ms(cuda_run, kernel=kname), device_ms(plain_run)
        bound, by = bound_ms(n_bytes, n_ops)
        lib_ms = None if lib is None else cuda_ms(lib)
        compact_rows[kname] = (ms, plain, bound, by, lib_ms)
        log(f"[times] {kname} window {MAIN_WINDOW}, Q={MAIN_Q}, shard 0: {ms:.4f} "
            f"ms/launch (device {dev_ms:.5f} ms); plain {plain:.4f} ms (device "
            f"{plain_dev:.5f} ms)" + ("" if lib is None else
                                     f"; torch.sort(stable) {lib_ms:.4f} ms")
            + f"; bound {bound:.6f} ms ({by}; {n_bytes} bytes: {extra}) on {smi}")

    # K6 / K6p
    q6, i6, heads6_h = groups_of(wl6)
    neff_h = ka[1].long().cpu().numpy()
    off_h = ka[0].long().cpu().numpy()
    live6 = np.clip(neff_h[q6] - i6 * TILE, 0, TILE)
    bounds6_h = bounds6.long().cpu().numpy()
    probe6 = table_probe_cost(wl6.desc, wl6.n_items, bounds6_h, 3, TILE)
    small6 = table_small(wl6, len(q6)) + 12 * MAIN_Q + 8 * MAIN_Q * MAIN_T
    out6 = 2 * MAIN_Q * MAIN_WINDOW * 4
    rows6 = wl6.desc[:wl6.n_items]
    row_group6 = np.cumsum(rows6[:, 4] & 1) - 1
    ops6 = int(live6[row_group6[rows6[:, 3] >= 0]].sum()) * int(math.log2(TILE))
    args6 = (desc6, heads6, ka[0], ka[1], ka[3], t_idx.postings, ka[5], bounds6)
    args6p = args6[:5] + (t_idx.packed,) + args6[6:]
    time_compact("K6", lambda: pi.driver_compact_join_cuda(*args6, window=MAIN_WINDOW),
                 lambda: pi.driver_compact_join_torch(*args6, window=MAIN_WINDOW),
                 small6 + int(live6.sum()) * 8 + probe6 * 4 + out6, ops6,
                 f"{len(q6)} groups, {int(live6.sum())} driver postings, probed "
                 f"{probe6} postings, {wl6.n_items} descriptor rows")
    d6_b, d6_blk = span_block_cost(torch.from_numpy(off_h[q6] + i6 * TILE),
                                   torch.from_numpy(live6), meta_host[0])
    p6_b, p6_blk = table_probe_cost(wl6.desc, wl6.n_items, bounds6_h, 3, TILE,
                                    meta_host[0])
    time_compact("K6p", lambda: pi.driver_compact_join_packed_cuda(
                     *args6p, window=MAIN_WINDOW),
                 lambda: pi.driver_compact_join_packed_torch(*args6p, window=MAIN_WINDOW),
                 small6 + d6_b + p6_b + int(live6.sum()) * 4 + out6,
                 ops6 + 4 * BLOCK * (d6_blk + p6_blk),
                 f"driver {d6_blk} blocks {d6_b} bytes, probes {p6_blk} blocks "
                 f"{p6_b} bytes, {wl6.n_items} descriptor rows")

    # K8 / K8p at fill 1.0
    d_meta1 = d1.packed.blk_meta[:d1.packed.n_blocks].cpu().numpy()
    na8 = k3m[3].long().clamp(max=MAIN_WINDOW)
    start8, dlen8 = dm._slab(k3m[8], d1.offsets, d1.lengths, cap)
    read8 = int((na8 + dlen8).clamp(max=MAIN_WINDOW).sum())
    small8 = table_small(wl8, MAIN_Q) + 5 * MAIN_Q * 4
    out8 = 3 * MAIN_Q * MAIN_WINDOW * 4
    ops8 = int(sum(min(a + b, MAIN_WINDOW) * (math.ceil(math.log2(min(a, b) + 1)) + 1)
                   for a, b in zip(na8.tolist(), dlen8.tolist())))
    args8 = (desc8, heads8, *k3m)
    args8p = (desc8, heads8, t_idx.packed, *k3m[1:4], d1.packed, *k3m[5:])
    m_docs8, _ = dm._stream(t_idx.postings, t_idx.attrs, k3m[2].long(), k3m[3].long(),
                            MAIN_WINDOW)
    d_docs8, _ = dm._stream(d1.postings, d1.attrs, start8, dlen8, cap)
    keys8 = torch.cat([m_docs8, d_docs8], dim=-1).contiguous()
    time_compact("K8", lambda: dm.merge_compact_cuda(*args8, window=MAIN_WINDOW, cap=cap),
                 lambda: dm.merge_compact_torch(*args8, window=MAIN_WINDOW, cap=cap),
                 small8 + read8 * 8 + out8, ops8,
                 f"{read8} postings of main {int(na8.sum())} + delta {int(dlen8.sum())} "
                 f"read, {wl8.n_items} descriptor rows",
                 lib=lambda: torch.sort(keys8, dim=-1, stable=True))
    m8_b, m8_blk = span_block_cost(k3m[2], na8, meta_host[0])
    dd8_b, dd8_blk = span_block_cost(start8, dlen8, d_meta1)
    time_compact("K8p", lambda: dm.merge_compact_packed_cuda(*args8p, window=MAIN_WINDOW,
                                                             cap=cap),
                 lambda: dm.merge_compact_packed_torch(*args8p, window=MAIN_WINDOW, cap=cap),
                 small8 + m8_b + dd8_b + read8 * 4 + out8,
                 ops8 + 4 * BLOCK * (m8_blk + dd8_blk),
                 f"main {m8_blk} blocks {m8_b} bytes, delta {dd8_blk} blocks {dd8_b} "
                 f"bytes, {read8} attrs")

    main_forms = {
        key: launched_forms(run, key) for key, run in (
            ("K8", lambda: dm.merge_compact_cuda(*args8, window=MAIN_WINDOW, cap=cap)),
            ("K8p", lambda: dm.merge_compact_packed_cuda(*args8p, window=MAIN_WINDOW,
                                                         cap=cap)))}
    if main_forms != {"K8": {"merge_compact_kernel"},
                      "K8p": {"merge_compact_packed_kernel"}}:
        raise AssertionError(f"K8/K8p at the main path's shapes launched {main_forms}")
    log(f"[compact] K8/K8p at the main path's shapes (window {MAIN_WINDOW}, cap {cap}) "
        f"launched {main_forms} (profiler trace): the chunk kernels")

    # K7 / K7p at fill 1.0
    a7_docs, _, a7_live, _, a7_active, a7_filter = k4m[:6]
    valid7 = (a7_docs != INVALID_DOC).long().sum(1)
    live7 = (a7_live != 0).long().sum(1)
    joins7 = a7_active.long().sum(1) > 0
    slots7 = (MAIN_Q * MAIN_WINDOW + int(valid7.sum()) + int(live7[joins7].sum())
              + int(valid7[a7_filter >= 0].sum()))
    b7_h, db7_h = bounds7.long().cpu().numpy(), dbounds7.long().cpu().numpy()
    pm7 = table_probe_cost(wl7.desc, wl7.n_items, b7_h, 3, TILE)
    pd7 = table_probe_cost(wl7.desc, wl7.n_items, db7_h, 5, TILE)
    small7 = table_small(wl7, len(groups_of(wl7)[0])) + 4 * MAIN_Q + 16 * MAIN_Q * MAIN_T
    out7 = MAIN_Q * MAIN_WINDOW * 4
    rows7 = wl7.desc[:wl7.n_items]
    q7, i7, _ = groups_of(wl7)
    slots_g7 = np.clip((a7_live != 0).long().view(MAIN_Q, -1, TILE).sum(-1)
                       .cpu().numpy()[q7, i7], 0, TILE)
    rg7 = np.cumsum(rows7[:, 4] & 1) - 1
    ops7 = int((slots_g7[rg7] * ((rows7[:, 3] >= 0).astype(np.int64)
                                 + (rows7[:, 5] >= 0))).sum()) * int(math.log2(TILE))
    args7 = (desc7, heads7, *k4m[:4], k4m[5], t_idx.postings, bounds7, d1.postings,
             dbounds7)
    args7p = args7[:7] + (t_idx.packed, bounds7, d1.packed, dbounds7)
    time_compact("K7", lambda: pi.streamed_compact_join_cuda(*args7),
                 lambda: pi.streamed_compact_join_torch(*args7),
                 small7 + slots7 * 4 + out7 + (pm7 + pd7) * 4, ops7,
                 f"{int(valid7.sum())} valid and {int(live7.sum())} live driver slots, "
                 f"probed main {pm7} + delta {pd7} postings, {wl7.n_items} descriptor rows")
    pm7_b, pm7_blk = table_probe_cost(wl7.desc, wl7.n_items, b7_h, 3, TILE, meta_host[0])
    pd7_b, pd7_blk = table_probe_cost(wl7.desc, wl7.n_items, db7_h, 5, TILE, d_meta1)
    time_compact("K7p", lambda: pi.streamed_compact_join_packed_cuda(*args7p),
                 lambda: pi.streamed_compact_join_packed_torch(*args7p),
                 small7 + slots7 * 4 + out7 + pm7_b + pd7_b,
                 ops7 + 4 * BLOCK * (pm7_blk + pd7_blk),
                 f"probes main {pm7_blk} blocks {pm7_b} bytes + delta {pd7_blk} blocks "
                 f"{pd7_b} bytes")

    def table_chain_log(key, desc, heads, tbounds, docs, keep, arrays, fences=None,
                        widths=None):
        """The main-shape launch's staging from its table's streams on the
        host (table_streams): the first design's (chain_before_table) and
        this one's (chain_after over the groups' sub-tiles).  ``arrays``:
        each kind's staging-check keywords."""
        lo, hi, _ = pi.table_streams(desc, heads, *tbounds)
        spt = len(tbounds)
        n = sum(pi.ranges_staging_check(lo[:, k::spt], hi[:, k::spt], **arrays[k])
                for k in range(spt))
        items, _, gq, gi = (x.cpu().numpy() for x in wlm.table_items(desc, heads))
        b = chain_before_table(items, [x.long().cpu().numpy() for x in tbounds],
                               widths is not None)
        q_n, num_a = docs.shape[0], -(-docs.shape[1] // TILE)
        rlo = np.zeros((q_n, lo.shape[1], num_a), np.int64)
        rhi = np.zeros_like(rlo)
        rlo[gq, :, gi] = lo.cpu().numpy()
        rhi[gq, :, gi] = hi.cpu().numpy()
        present = np.zeros((q_n, num_a), bool)
        present[gq, gi] = True
        a = chain_after(rlo, rhi, docs.cpu().numpy(), keep.cpu().numpy(),
                        caps=probe_caps, fences=fences, widths=widths, present=present)
        smem = probe_lib.probe_smem_bytes(lo.shape[1], int(widths is not None))
        what = "decoded" if widths is not None else "staged"
        log(f"[chain] {key} main shape, from its table's streams (the staging "
            f"precondition holds on all {n} of them): first design {b[0]} blocks, one "
            f"a group, {b[1]} postings {what} ({b[2]} by the busiest block), {b[3]} "
            f"dependent loads on the longest chain, one synchronous tile a row, "
            f"{OLD_SMEM} bytes of shared memory a block; sub-tile {probe_caps[0]}: "
            f"{a[0]} blocks, {a[1]} postings {what} ({a[2]} by the busiest block), 3 "
            f"dependent loads before the copies (heads, rows, bounds), then {a[3]} "
            f"rounds and {a[4]} narrowing passes on the longest chain, {smem} bytes of "
            f"dynamic shared memory a block")

    pos6 = torch.arange(MAIN_WINDOW, device=dev)
    gpos = (ka[0][:, None].long() + pos6).clamp(max=t_idx.postings.numel() - 1)
    win6 = pos6[None] < ka[1][:, None]
    docs6 = torch.where(win6, t_idx.postings[gpos], INVALID_DOC)
    keep6 = win6 & (docs6 != INVALID_DOC) & (
        (ka[3][:, None] < 0) | (t_idx.attrs[gpos] == ka[3][:, None]))
    keep7 = (a7_docs != INVALID_DOC) & (a7_live != 0) & (
        (a7_filter[:, None] < 0) | (k4m[1] == a7_filter[:, None]))
    m_fence = t_idx.packed.blk_base[:t_idx.packed.n_blocks].long().cpu().numpy()
    d_fence = d1.packed.blk_base[:d1.packed.n_blocks].long().cpu().numpy()
    raw_chk = [{"n_postings": t_idx.postings.numel()},
               {"n_postings": d1.postings.numel()}]
    pk_chk = [{"packed": t_idx.packed}, {"packed": d1.packed}]
    table_chain_log("K6", desc6, heads6, (bounds6,), docs6, keep6, raw_chk)
    table_chain_log("K6p", desc6, heads6, (bounds6,), docs6, keep6, pk_chk, [m_fence],
                    [meta_host[0] & 63])
    table_chain_log("K7", desc7, heads7, (bounds7, dbounds7), a7_docs, keep7, raw_chk)
    table_chain_log("K7p", desc7, heads7, (bounds7, dbounds7), a7_docs, keep7, pk_chk,
                    [m_fence, d_fence], [meta_host[0] & 63, d_meta1 & 63])

    # device ms beside the dense twins, all 32 live and 20 of 32 live (the
    # last 12 inert clones of the 20th, as the scheduler pads)
    _, pad_batch, pad_live = live_cases(main_batch)[1]
    for mix, b, live in (("all live", main_batch, None),
                         (f"{int(pad_live.sum())} of {MAIN_Q} live", pad_batch, pad_live)):
        a1 = k1_inputs(t_idx, b, MAIN_WINDOW)
        wl_b, bnd_b = pi.plan_driver_compact(
            a1[0], a1[1], b.terms, a1[2], t_idx.offsets, t_idx.lengths,
            t_idx.block_max, window=MAIN_WINDOW, live_q=live)
        a6 = (*wlm.table_to_device(wl_b, dev), a1[0], a1[1], a1[3], t_idx.postings,
              a1[5], bnd_b)
        _, k4b, _ = k4_inputs(f"compact twins {mix}", t_idx, d1, b, MAIN_WINDOW, True)
        wl7_b, b7_b, db7_b = pi.plan_streamed_compact(
            k4b[0], b.terms, k4b[4], t_idx.offsets, t_idx.lengths, t_idx.block_max,
            d1.offsets, d1.lengths, d1.block_max, live_q=live)
        a7 = (*wlm.table_to_device(wl7_b, dev), *k4b[:4], k4b[5], t_idx.postings, b7_b,
              d1.postings, db7_b)
        pk4b = k4b[:6] + (t_idx.packed,) + k4b[7:10] + (d1.packed,) + k4b[11:]
        runs = (
            ("K6", lambda: pi.driver_compact_join_cuda(*a6, window=MAIN_WINDOW), "K1",
             lambda: pi.driver_streamed_join_cuda(*a1, window=MAIN_WINDOW)),
            ("K6p", lambda: pi.driver_compact_join_packed_cuda(
                *a6[:5], t_idx.packed, *a6[6:], window=MAIN_WINDOW), "K1p",
             lambda: pi.driver_streamed_join_packed_cuda(
                 *a1[:4], t_idx.packed, *a1[5:], window=MAIN_WINDOW)),
            ("K7", lambda: pi.streamed_compact_join_cuda(*a7), "K4",
             lambda: pi.streamed_join_cuda(*k4b, cap=cap)),
            ("K7p", lambda: pi.streamed_compact_join_packed_cuda(
                *a7[:7], t_idx.packed, b7_b, d1.packed, db7_b), "K4p",
             lambda: pi.streamed_join_packed_cuda(*pk4b, cap=cap)))
        log(f"[times] device ms beside the dense twin ({mix}; slave 0, Q={MAIN_Q}, "
            f"T={MAIN_T}, W={MAIN_WINDOW}, K7 at fill 1.0; tables of {wl_b.n_items} / "
            f"{wl7_b.n_items} rows (K6 / K7)): " + ", ".join(
                f"{k} {device_ms(run, kernel=k):.5f} vs {twin} "
                f"{device_ms(dense_run, kernel=twin):.5f}"
                for k, run, twin, dense_run in runs) + f" on {smi}")

    # occupancy and per-batch time, all live against 20 of 32 live (the
    # last 12 inert clones of the 20th, as the scheduler pads)
    n_live = MAIN_Q - 12
    pad_batches = [live_cases(b)[1][1] for b in batches]
    mixes = {"all live": (batches, None),
             f"{n_live} of {MAIN_Q} live": (pad_batches, np.arange(MAIN_Q) < n_live)}
    cells = (("static", None), ("fill 1.0", p_views[1.0]))

    def slaves(bs, backend, live, deltas_):
        kw = {"live_q": live} if backend == "kernel_compact" else {}
        for b in bs:
            for s in range(NS):
                query_topk(raw_shards[s], b, delta=None if deltas_ is None else deltas_[s],
                           k=k_all, window=MAIN_WINDOW, backend=backend, **kw)

    for mix, (bs, live) in mixes.items():
        for cell, deltas_ in cells:
            occ: dict[str, list[float]] = {}
            for b in bs:
                for s in range(NS):
                    reg = MetricsRegistry()
                    prev = set_registry(reg)
                    try:
                        query_topk(raw_shards[s], b, k=k_all, window=MAIN_WINDOW,
                                   delta=None if deltas_ is None else deltas_[s],
                                   backend="kernel_compact", live_q=live)
                    finally:
                        set_registry(prev)
                    for name, _, _, series in reg.collect():
                        if name == "odys_kernel_grid_occupancy":
                            for labels, g in series:
                                occ.setdefault(labels["kernel"], []).append(g.value)
            log(f"[compact] occupancy gauge ({mix}, {cell}; live items / dense-grid "
                f"steps, mean over {len(bs)} batches x {NS} slaves): " + ", ".join(
                    f"{k} {np.mean(v):.4f}" for k, v in sorted(occ.items())))
            order = ("kernel", "kernel_compact", "kernel_compact", "kernel")
            for backend in order[:2]:
                slaves(bs[:2], backend, live, deltas_)
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    slaves(bs, backend, live, deltas_)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t
                kern = [e for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA]
                busy = sum(e.self_device_time_total for e in kern) / 1e6
                log(f"[trace] slave phase, {backend} ({mix}, {cell}): "
                    f"{sum(e.count for e in kern) / len(bs):.1f} device ops and "
                    f"{busy / len(bs) * 1e3:.3f} ms of device time per batch, busy "
                    f"share {busy / wall:.4f} of {wall * 1e3:.3f} ms traced")
            ms = []
            for backend in order:
                torch.cuda.synchronize()
                t = time.perf_counter()
                slaves(bs, backend, live, deltas_)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) / len(bs) * 1e3)
            log(f"[times] slave phase per batch of {MAIN_Q} ({mix}, {cell}; {NS} slaves' "
                f"query_topk, ms, host clock around synchronize, in turns dense / "
                f"compact / compact / dense): " + " / ".join(f"{x:.3f}" for x in ms)
                + f" on {smi}")
    phase_end("12 compact")

    # ------------------------------------------------------------ 13. staged
    def k9_args(idx, batch, window, filt=True, delta=None, b_window=None):
        """K9's operands for one slave as the staged backend stages them
        (``_query_windows``); ``b_window`` re-stages the other-term windows
        at another width."""
        docs, attrs, live, others, active = _query_windows(
            make_posting_source(idx, delta), batch, window=window,
            attr_strategy="embed")
        if b_window is not None:
            others = term_window(idx, batch.terms, b_window)[0]
        attr = batch.attr_filter if filt else torch.full_like(batch.attr_filter, -1)
        return pi.batched_block_skip_args(docs, attrs, others, active, attr, live)

    def k9_check(label, a9):
        got = pi.batched_block_skip_join_cuda(*a9)
        torch.cuda.synchronize()
        same("K9", label, (got,), (pi.batched_block_skip_join_torch(*a9),), ("mask",))
        return int(got.sum())

    n9, sums9 = 0, []
    for s in range(NS):
        idx, delta = raw_shards[s], p_views[1.0][s]
        for label, kw in (
            ("main filter-on", dict(batch=main_batch, window=MAIN_WINDOW)),
            ("main filter-off", dict(batch=main_batch, window=MAIN_WINDOW, filt=False)),
            ("window 1000", dict(batch=main_batch, window=1000)),
            ("window 1536", dict(batch=main_batch, window=1536)),
            ("empty drivers, inactive slots", dict(batch=edge_batches[s],
                                                   window=MAIN_WINDOW)),
            ("W_a 4096, W_b 3000", dict(batch=main_batch, window=MAIN_WINDOW,
                                        b_window=3000)),
            ("W_a 1000, W_b 4096", dict(batch=main_batch, window=1000,
                                        b_window=MAIN_WINDOW)),
            ("fill 1.0 a_live filter-on", dict(batch=main_batch, window=MAIN_WINDOW,
                                               delta=delta)),
            ("fill 1.0 a_live filter-off", dict(batch=main_batch, window=MAIN_WINDOW,
                                                delta=delta, filt=False)),
        ):
            sums9.append(k9_check(f"shard {s} {label}", k9_args(idx, **kw)))
            n9 += 1
    log(f"[staged] K9 bit-exact vs its plain version on {NS} slaves x {n9 // NS} cases "
        f"(main-path shapes filter on/off, windows 1000 and 1536, empty drivers and "
        f"inactive slots, W_b 3000 < W_a and W_b 4096 > W_a 1000, fill 1.0 with a_live); "
        f"mask sums {sums9[:9]}")

    # three more K9 cases: skip ranges longer than one round of the probe's
    # buffer, every slot dying at the first term, a_live null against ones
    raw_cap = probe_caps[1]
    n_new9, longest9 = 0, 0
    for s in range(NS):
        idx = raw_shards[s]
        a9 = k9_args(idx, big_batch(s), MAIN_WINDOW, b_window=BIG_WINDOW)
        lo9, hi9, _ = pi.skip_streams(a9[6], a9[7], a9[4], a9[3].shape[-1])
        longest9 = max(longest9, int((hi9 - lo9).max()))
        k9_check(f"shard {s} W_b {BIG_WINDOW}, big_batch drivers", a9)
        docs, attrs, live, others, active = _query_windows(
            make_posting_source(idx, p_views[1.0][s]), main_batch, window=MAIN_WINDOW,
            attr_strategy="embed")
        # term slot 0 holds each driver's docIDs + 1 that are not its docIDs:
        # its skip ranges are not empty, and no slot is found in them
        d_h = docs.cpu().numpy()
        first = np.full(others.shape[::2], INVALID_DOC, np.int32)
        for q in range(d_h.shape[0]):
            v = d_h[q][d_h[q] != INVALID_DOC].astype(np.int64)
            miss = np.setdiff1d(v + 1, v)[:others.shape[-1]]
            first[q, :miss.size] = miss
        dead = others.clone()
        dead[:, 0] = torch.from_numpy(first).to(dev)
        act0 = active.clone()
        act0[:, 0] = 1
        a9d = pi.batched_block_skip_args(docs, attrs, dead, act0, main_batch.attr_filter,
                                         live)
        if int(a9d[7][:, 0].sum()) == 0:
            raise AssertionError("the first-term case's skip ranges are all empty")
        if k9_check(f"shard {s} every slot dies at the first term", a9d) != 0:
            raise AssertionError(f"shard {s}: a slot survived a first term that "
                                 "holds none of its docIDs")
        a9n = pi.batched_block_skip_args(docs, attrs, others, active,
                                         main_batch.attr_filter, None)
        k9_check(f"shard {s} a_live null", a9n)
        k9_check(f"shard {s} a_live all ones",
                 a9n[:2] + (torch.ones_like(a9n[0]),) + a9n[3:])
        got_null = pi.batched_block_skip_join_cuda(*a9n)
        got_ones = pi.batched_block_skip_join_cuda(
            *(a9n[:2] + (torch.ones_like(a9n[0]),) + a9n[3:]))
        torch.cuda.synchronize()
        same("K9", f"shard {s} a_live null vs all ones", (got_null,), (got_ones,),
             ("mask",))
        n_new9 += 4
    if full_size and longest9 <= raw_cap:
        raise AssertionError(f"K9 at W_b {BIG_WINDOW}: the longest skip range holds "
                             f"{longest9} postings, not past one round ({raw_cap})")
    log(f"[staged] K9 bit-exact vs its plain version in {n_new9} more cases: W_b "
        f"{BIG_WINDOW} with big_batch drivers (longest skip range {longest9} postings, "
        f"one round holds {raw_cap}), every slot dead at the first term (non-empty "
        f"ranges, no docID found; mask 0), a_live null equal to all ones")
    a9m = k9_args(raw_shards[0], main_batch, MAIN_WINDOW)
    lo9, hi9, act9 = pi.skip_streams(a9m[6], a9m[7], a9m[4], a9m[3].shape[-1])
    n_ranges9 = pi.ranges_staging_check(lo9, hi9, n_postings=a9m[3].numel())
    k9_launched = {k: v for k, v in kernel_launches(
        lambda: pi.batched_block_skip_join_cuda(*a9m)).items() if "staged_join_kernel" in k}
    want_grid = (4 * (a9m[0].shape[1] // TILE), MAIN_Q, 1)
    if not k9_launched:
        raise AssertionError("K9: no staged_join_kernel among the device events")
    grids9 = set().union(*(g for _, g in k9_launched.values()))
    if any(g != want_grid for g, _ in grids9):
        raise AssertionError(f"K9's grids {grids9}, expected {want_grid}")
    log(f"[staged] K9 at the main path's shapes: {n_ranges9} non-empty skip ranges "
        f"stage (16-byte starts, inside b_docs; skip_streams), the longest "
        f"{int((hi9 - lo9).max())} postings; the profiler shows staged_join_kernel "
        + (", ".join(f"grid {g} ({math.prod(g)} blocks), block {b}" for g, b in grids9)
           if grids9 else "(grid not in the trace: blocks not measured)"))

    rng13 = np.random.default_rng(args.seed + 13)

    def sorted_list(n, valid, hi):
        v = np.sort(rng13.choice(hi, size=valid, replace=False)).astype(np.int32)
        return torch.from_numpy(np.concatenate(
            [v, np.full(n - valid, INVALID_DOC, np.int32)])).to(dev)

    def k10_check(label, a10):
        got = pi.block_skip_join_cuda(*a10)
        torch.cuda.synchronize()
        same("K10", label, (got,), (pi.block_skip_join_torch(*a10),), ("mask",))
        return int(got.sum())

    # tests/test_kernels.py's sweep, then benchmarks/bench_kernels.py's shape
    k10_shapes = [(1024, 1024, 1024, 1024, 50_000), (1024, 500, 2048, 1700, 50_000),
                  (2048, 2048, 1024, 64, 50_000), (1024, 0, 1024, 512, 50_000),
                  (4096, 3000, 4096, 4000, 50_000), (512, 300, 768, 400, 50_000),
                  (4096, 4000, 8192, 8000, 10**6)]
    for na, va, nb, vb, hi in k10_shapes:
        a10, b10 = sorted_list(na, va, hi), sorted_list(nb, vb, hi)
        at10 = torch.from_numpy(rng13.integers(0, 8, na).astype(np.int32)).to(dev)
        for f in (-1, 2):
            k10_check(f"{na}/{va} x {nb}/{vb} filter {f}", pi.block_skip_args(
                a10, at10, b10, f))
    bench10 = pi.block_skip_args(a10, at10, b10, -1)
    # skip ranges past one round of the probe's buffer (4096 postings), and
    # an empty other list: every slot dies
    a_long, b_long = sorted_list(2048, 2000, 10**5), sorted_list(65536, 60000, 10**5)
    at_long = torch.from_numpy(rng13.integers(0, 8, 2048).astype(np.int32)).to(dev)
    long10 = pi.block_skip_args(a_long, at_long, b_long, -1)
    longest10 = int(long10[5].max()) * TILE
    if longest10 <= 4096:
        raise AssertionError(f"K10: longest skip range {longest10} postings, not past "
                             f"one round of 4096")
    long_sums = [k10_check(f"skip ranges up to {longest10} postings filter {f}",
                           pi.block_skip_args(a_long, at_long, b_long, f)) for f in (-1, 2)]
    dead_sum = k10_check("empty other list", pi.block_skip_args(
        a_long, at_long, sorted_list(1024, 0, 10**5), -1))
    if dead_sum != 0:
        raise AssertionError(f"K10: {dead_sum} members of an empty list")
    idx0 = raw_shards[0]
    hot1, hot2 = (int(t) for t in torch.topk(idx0.lengths, 2).indices)

    def whole(t):
        off, n = int(idx0.offsets[t]), int(idx0.lengths[t])
        return idx0.postings[off:off + n], idx0.attrs[off:off + n]

    (a_hot, aa_hot), (b_hot, _) = whole(hot2), whole(hot1)
    hot_sums = [k10_check(f"hottest lists filter {f}", pi.block_skip_args(
        a_hot, aa_hot, b_hot, f)) for f in (-1, 3)]
    hot10 = pi.block_skip_args(a_hot, aa_hot, b_hot, -1)
    log(f"[staged] K10 bit-exact vs its plain version on {len(k10_shapes)} shapes x "
        f"filter on/off (tests/test_kernels.py's and bench_kernels.py's 4096 x 8192) "
        f"and the two hottest lists of slave 0 whole (term {hot2}, "
        f"{a_hot.numel()} postings, in term {hot1}, {b_hot.numel()}): {hot_sums} hits; "
        f"2048 x 65536 with skip ranges up to {longest10} postings: {long_sums} hits; "
        f"against an empty list: mask 0")
    for label, a10_ in (("4096 x 8192", bench10), ("hottest lists", hot10)):
        a_, _, b_, _, bs_, nb_ = a10_
        lo10, hi10, _ = pi.skip_streams(bs_[None, None], nb_[None, None], None,
                                        b_.shape[0])
        n_ranges10 = pi.ranges_staging_check(lo10, hi10, n_postings=b_.numel())
        launched10 = {k: v for k, v in kernel_launches(
            lambda a10_=a10_: pi.block_skip_join_cuda(*a10_)).items()
            if "skip_join_kernel" in k}
        if not launched10:
            raise AssertionError("K10: no skip_join_kernel among the device events")
        grids10 = set().union(*(g for _, g in launched10.values()))
        want10 = (4 * (a_.shape[0] // TILE), 1, 1)
        if any(g != want10 for g, _ in grids10):
            raise AssertionError(f"K10's grids {grids10}, expected {want10}")
        log(f"[staged] K10 {label}: {n_ranges10} non-empty skip ranges stage "
            f"(skip_streams at Q = T = 1), the longest {int((hi10 - lo10).max())} "
            f"postings; the profiler shows skip_join_kernel "
            + (", ".join(f"grid {g} ({math.prod(g)} blocks), block {b}"
                         for g, b in grids10)
               if grids10 else "(grid not in the trace: blocks not measured)"))

    def k11_check(label, x):
        got = tm.bitonic_sort_cuda(x)
        torch.cuda.synchronize()
        same("K11", label, (got,), (tm.bitonic_sort_torch(x),), ("sorted",))
        return got

    tile = tm.SORT_TILE
    k11_sizes = (2, 7, 777, tile - 1, tile, tile + 1, 2 * tile, 32768, 32769,
                 (1 << 18) + 1, 1 << 20)
    for dtype in (torch.int32, torch.float32):
        for n in k11_sizes:
            x = torch.from_numpy(rng13.integers(-(1 << 30), 1 << 30, n).astype(
                np.int32)).to(dev).to(dtype)
            x[: n // 4] = x[n // 2]                         # ties
            k11_check(f"{dtype} n={n}", x)
        for order, n in (("sorted", 3 * tile + 5), ("reversed", 3 * tile + 5),
                         ("one value", 5 * tile), ("all INVALID_DOC", 2 * tile + 1)):
            x = {"sorted": torch.arange(n, device=dev),
                 "reversed": torch.arange(n, 0, -1, device=dev),
                 "one value": torch.full((n,), -7, device=dev),
                 "all INVALID_DOC": torch.full((n,), int(INVALID_DOC), device=dev),
                 }[order].to(dtype)
            k11_check(f"{dtype} {order} n={n}", x)
    r4 = k11_check("R4 pad quirk", torch.tensor(
        [3, float("inf"), -1, 3e9, 5], dtype=torch.float32, device=dev))
    if r4.tolist() != [-1.0, 3.0, 5.0, 2.0**31, 2.0**31]:
        raise AssertionError(f"K11: the pad quirk gives {r4.tolist()}")
    # the launches of one 2**20 sort, read from the profiler's device events
    x20 = torch.from_numpy(rng13.integers(0, 1 << 30, 1 << 20).astype(np.int32)).to(dev)
    tm.bitonic_sort_cuda(x20)
    torch.cuda.synchronize()
    want_launches = 1 + int(math.log2((1 << 20) // tile))
    # the window opens with 64 short spins, as device_ms' do (the profiler
    # loses a window's first events late in a run); a window in which it
    # dropped some of the sort's all the same is taken again, up to three
    # times
    for _ in range(3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.cuda._sleep(1000)
            tm.bitonic_sort_cuda(x20)
            torch.cuda.synchronize()
        k11_events = {e.key: e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and any(name in e.key for name in kernel_names("K11"))}
        if sum(k11_events.values()) == want_launches:
            break
    if sum(k11_events.values()) != want_launches:
        raise AssertionError(f"K11: a 2**20 sort launched {k11_events}, expected "
                             f"1 + log2(m / {tile}) = {want_launches}")
    log(f"[staged] K11 launches for one 2**20 sort: {sum(k11_events.values())} "
        f"(1 + log2(2**20 / {tile}) = {want_launches}; "
        + ", ".join(f"{k[:40]} x{c}" for k, c in k11_events.items()) + ")")
    for ns_, k_ in ((16, 128), (4, 1000)):
        c = torch.from_numpy(np.sort(rng13.integers(0, 1 << 28, (ns_, k_)).astype(
            np.int32), axis=1)).to(dev)
        got = tm.merge_topk(c, k_)
        torch.cuda.synchronize()
        same("K11", f"merge_topk ({ns_}, {k_})", (got,),
             (tm.bitonic_sort_torch(c.reshape(-1))[:k_],), ("top-k",))
    log(f"[staged] K11 bit-exact vs its plain version, int32 and float32, n in "
        f"{k11_sizes} (one block a tile of {tile} keys, merge passes past it), and "
        f"sorted, reversed, one-value and all-INVALID_DOC vectors; [3, inf, -1, 3e9, "
        f"5] -> [-1, 3, 5, 2**31, 2**31] as the reference's pad gives it; merge_topk "
        f"at (16, 128) and (4, 1000)")

    def static_args(s, batch, window, filt=True, live_q=None):
        """The static modes' operands on slave s: the staged windows of the
        drivers, K4's main plan and K7's table (of the ``live_q`` queries),
        and K9's mask on them."""
        idx_p = twins[s]
        docs, attrs, _, others, active = _query_windows(
            StaticPostingSource(idx_p), batch, window=window, attr_strategy="embed")
        attr = (batch.attr_filter if filt
                else torch.full_like(batch.attr_filter, -1)).contiguous()
        k9 = pi.batched_block_skip_join_cuda(*pi.batched_block_skip_args(
            docs, attrs, others, active, attr))[:, :window]
        live = (docs != INVALID_DOC).to(torch.int32)
        main, _, _ = pi.plan_streamed(docs, batch.terms, active, idx_p.offsets,
                                      idx_p.lengths, idx_p.block_max)
        a4 = (docs, attrs, live, None, active, attr, idx_p.postings, *main,
              None, None, None, None)
        wl, bounds, _ = pi.plan_streamed_compact(
            docs, batch.terms, active, idx_p.offsets, idx_p.lengths, idx_p.block_max,
            live_q=live_q)
        desc, heads = wlm.table_to_device(wl, dev)
        a7 = (desc, heads, docs, attrs, live, None, attr, idx_p.postings, bounds,
              None, None)
        return {"K4s": (pi.streamed_join_cuda, pi.streamed_join_torch, a4, {"cap": 0}),
                "K4ps": (pi.streamed_join_packed_cuda, pi.streamed_join_packed_torch,
                         a4[:6] + (idx_p.packed,) + a4[7:], {"cap": 0}),
                "K7s": (pi.streamed_compact_join_cuda, pi.streamed_compact_join_torch,
                        a7, {}),
                "K7ps": (pi.streamed_compact_join_packed_cuda,
                         pi.streamed_compact_join_packed_torch,
                         a7[:7] + (idx_p.packed,) + a7[8:], {})}, k9, wl

    for s in range(NS):
        for label, batch, window, filt in (
            ("main filter-on", main_batch, MAIN_WINDOW, True),
            ("main filter-off", main_batch, MAIN_WINDOW, False),
            ("window 1000", main_batch, 1000, True),
            ("empty drivers", edge_batches[s], MAIN_WINDOW, True),
        ):
            modes, k9, _ = static_args(s, batch, window, filt)
            for key, (cuda_fn, plain_fn, a, kw) in modes.items():
                got = cuda_fn(*a, **kw)
                torch.cuda.synchronize()
                ctx = f"shard {s} {label}"
                same(key, ctx, (got,), (plain_fn(*a, **kw),), ("mask",))
                same(key, ctx + " vs K9", (got,), (k9,), ("mask",))
    log(f"[staged] static K4, K4p, K7, K7p (no delta arrays) bit-exact vs their plain "
        f"versions and vs K9 on the staged windows of the same drivers, {NS} slaves x "
        f"4 cases (main filter on/off, window 1000, empty drivers)")

    # the ops entry points, each a path of its own: counts reset, the call,
    # counts read
    x4k = torch.from_numpy(rng13.integers(0, 1 << 30, 4096).astype(np.int32)).to(dev)
    c16 = torch.from_numpy(np.sort(rng13.integers(0, 1 << 28, (16, 128)).astype(
        np.int32), axis=1)).to(dev)
    s_docs, s_attrs, _, _, s_active = _query_windows(
        StaticPostingSource(twins[0]), main_batch, window=MAIN_WINDOW,
        attr_strategy="embed")
    s_live = (s_docs != INVALID_DOC).to(torch.int32)
    t0_ = twins[0]
    ops_paths = {
        "K10": lambda: ops.intersect(a_hot, aa_hot, b_hot, -1),
        "K11": lambda: (ops.sort(x4k), ops.topk_merge(c16, 128)),
        "K4": lambda: ops.intersect_streamed(
            s_docs, s_attrs, s_live, main_batch.terms, s_active, main_batch.attr_filter,
            t0_.postings, t0_.offsets, t0_.lengths, t0_.block_max),
        "K4p": lambda: ops.intersect_streamed(
            s_docs, s_attrs, s_live, main_batch.terms, s_active, main_batch.attr_filter,
            t0_.postings, t0_.offsets, t0_.lengths, t0_.block_max, packed=t0_.packed),
        "K7": lambda: ops.intersect_streamed_compact(
            s_docs, s_attrs, s_live, main_batch.terms, s_active, main_batch.attr_filter,
            t0_.postings, t0_.offsets, t0_.lengths, t0_.block_max),
        "K7p": lambda: ops.intersect_streamed_compact(
            s_docs, s_attrs, s_live, main_batch.terms, s_active, main_batch.attr_filter,
            t0_.postings, t0_.offsets, t0_.lengths, t0_.block_max, packed=t0_.packed),
    }
    ops_counts = {}
    for key, run in ops_paths.items():
        reset_launches()
        run()
        torch.cuda.synchronize()
        counts = launches_now()
        if counts != {**no_launch, key: counts[key]} or counts[key] == 0:
            raise AssertionError(f"ops path {key}: launches {counts}")
        ops_counts[key] = counts[key]
    log(f"[staged] ops entry points launch their kernels and nothing else: "
        f"{ops_counts} (ops.sort + ops.topk_merge for K11; the static modes through "
        f"ops.intersect_streamed[_compact] without delta arrays)")

    def staged_oracle(shards_, deltas_, batch, k):
        """The staged path's semantics in plain torch ops, independent of K9
        and its skip map: per slave the staged windows, membership by
        ``member_sorted`` per active slot, the fused predicate, first k;
        merged as ``sequential_reference`` merges."""
        cands, hits = [], []
        for s, idx in enumerate(shards_):
            docs, attrs, live, others, active = _query_windows(
                make_posting_source(idx, None if deltas_ is None else deltas_[s]),
                batch, window=MAIN_WINDOW, attr_strategy="embed")
            f = batch.attr_filter[:, None]
            mask = (docs != INVALID_DOC) & ((f < 0) | (attrs == f))
            if live is not None:
                mask &= live != 0
            for t in range(others.shape[1]):
                mask &= member_sorted(docs, others[:, t]) | (active[:, t:t + 1] == 0)
            d, h = _first_k_by_rank(docs, mask, k)
            cands.append(local_to_global_docids(d, s, NS))
            hits.append(h)
        return (torch.cat(cands, -1).sort(-1).values[:, :k],
                torch.stack(hits).sum(0, dtype=torch.int32))

    def staged_path(label, deltas_):
        reset_launches()
        results = []
        for b in batches:
            before = launches_now()
            results.append(sequential_reference(
                raw_shards, b, ns=NS, k=k_all, window=MAIN_WINDOW, deltas=deltas_,
                backend="kernel_staged"))
            per = {k: v - before[k] for k, v in launches_now().items()}
            if per != {**no_launch, "K9": NS}:
                raise AssertionError(f"staged {label}: launches per batch {per}")
        counts = launches_now()
        torch.cuda.synchronize()
        n_diff = {"kernel": 0, "torch": 0}
        for b, r in zip(batches, results):
            od, oh = staged_oracle(raw_shards, deltas_, b, k_all)
            if not (torch.equal(r.docids, od) and torch.equal(r.n_hits, oh)):
                raise AssertionError(f"staged {label}: differs from the staged oracle")
            for backend in n_diff:
                w = sequential_reference(raw_shards, b, ns=NS, k=k_all,
                                         window=MAIN_WINDOW, deltas=deltas_,
                                         backend=backend)
                rows = (r.docids != w.docids).any(1) | (r.n_hits != w.n_hits)
                n_diff[backend] += int(rows.sum())
        if deltas_ is None and any(n_diff.values()):
            raise AssertionError(f"staged {label}: differs from the streamed paths "
                                 f"on {n_diff} queries")
        log(f"[staged] {label}: {len(queries)} queries in {len(batches)} batches through "
            f"sequential_reference(backend='kernel_staged') equal the plain staged "
            f"oracle; queries differing from backend='kernel' / 'torch': "
            f"{n_diff['kernel']} / {n_diff['torch']}; launches {counts}, per batch "
            f"K9 {NS}; total n_hits {sum(int(r.n_hits.sum()) for r in results)}")
        return results, counts, n_diff

    st_static, st_counts, _ = staged_path("static", None)
    st_mor, st_mor_counts, st_ndiff = staged_path("fill 1.0", p_views[1.0])
    for label, dl_raw, dl_blind, want in (("static", None, None, st_static[0]),
                                          ("fill 1.0", p_views[1.0], blind_deltas,
                                           st_mor[0])):
        r = sequential_reference(blind, batches[0], ns=NS, k=k_all, window=MAIN_WINDOW,
                                 deltas=dl_blind, backend="kernel_staged",
                                 codec="packed")
        if not (torch.equal(r.docids, want.docids) and torch.equal(r.n_hits, want.n_hits)):
            raise AssertionError(f"staged packed {label}: differs from raw")
    log("[staged] one batch with codec='packed' (every raw posting zeroed, decoded "
        "whole first) equals raw, static and at fill 1.0")

    # times, slave 0, main-path shapes
    staged_rows = {}

    def time_row(key, run, plain_run, n_bytes, n_ops, extra, lib=None, lib_name="",
                 kernel=None):
        ms, plain = cuda_ms(run), cuda_ms(plain_run, reps=10, warmup=2)
        dev_ms, plain_dev = device_ms(run, kernel=kernel), device_ms(plain_run)
        bound, by = bound_ms(n_bytes, n_ops)
        lib_ms = None if lib is None else cuda_ms(lib)
        staged_rows[key] = (ms, plain, bound, by, lib_ms)
        log(f"[times] {key} {extra}: {ms:.4f} ms/launch (device {dev_ms:.5f} ms); "
            f"plain {plain:.4f} ms (device {plain_dev:.5f} ms)"
            + ("" if lib is None else f"; {lib_name} {lib_ms:.4f} ms")
            + f"; bound {bound:.6f} ms ({by}; {n_bytes} bytes) on {smi}")

    def k9_cost(a9):
        a, aa, al, b, active, filt, b_start, n_b = a9
        q_n, w_b = a.shape[0], b.shape[-1]
        valid = (a != INVALID_DOC).long().sum(1)
        span = torch.tensor([0, w_b], dtype=torch.int32, device=dev).expand(
            *active.shape, 2)
        probed = probed_postings(b_start, n_b, span, TILE)
        n_bytes = (a.numel() + int(valid[filt >= 0].sum())
                   + (0 if al is None else int(valid.sum()))
                   + active.numel() + q_n + 2 * b_start.numel() + probed
                   + a.numel()) * 4
        n_ops = int((valid * active.long().sum(1)).sum()) * math.ceil(math.log2(w_b))
        return n_bytes, n_ops, probed

    for label, a9 in (("static", k9_args(idx0, main_batch, MAIN_WINDOW)),
                      ("fill 1.0", k9_args(idx0, main_batch, MAIN_WINDOW,
                                           delta=p_views[1.0][0]))):
        n_bytes, n_ops, probed = k9_cost(a9)
        time_row(f"K9 {label}", lambda a9=a9: pi.batched_block_skip_join_cuda(*a9),
                 lambda a9=a9: pi.batched_block_skip_join_torch(*a9), n_bytes, n_ops,
                 f"Q={MAIN_Q}, T={MAIN_T}, W={MAIN_WINDOW}, shard 0, {probed} "
                 f"postings in skip ranges", kernel="K9")

    def k10_cost(a10):
        a, aa, b, filt, b_start, n_b = a10
        valid = int((a != INVALID_DOC).sum())
        span = torch.tensor([[[0, b.shape[0]]]], dtype=torch.int32, device=dev)
        probed = probed_postings(b_start[None, None], n_b[None, None], span, TILE)
        n_bytes = (a.numel() + (valid if int(filt) >= 0 else 0) + 2 + 2 * b_start.numel()
                   + probed + a.numel()) * 4
        return n_bytes, valid * math.ceil(math.log2(max(b.shape[0], 2))), probed

    for label, a10 in (("bench 4096 x 8192", bench10), ("hottest lists", hot10)):
        n_bytes, n_ops, probed = k10_cost(a10)
        a_, b_ = a10[0], a10[2]
        time_row(f"K10 {label}", lambda a10=a10: pi.block_skip_join_cuda(*a10),
                 lambda a10=a10: pi.block_skip_join_torch(*a10), n_bytes, n_ops,
                 f"{a_.numel()} x {b_.numel()}, {probed} postings in skip ranges",
                 lib=lambda a_=a_, b_=b_: torch.isin(a_, b_),
                 lib_name="torch.isin (membership alone)", kernel="K10")

    for label, x in (("int32 n=4096 (bench)", x4k),
                     ("int32 n=2**20", torch.from_numpy(rng13.integers(
                         0, 1 << 30, 1 << 20).astype(np.int32)).to(dev)),
                     ("float32 n=2**20", torch.from_numpy(rng13.normal(
                         size=1 << 20).astype(np.float32)).to(dev))):
        n = x.numel()
        time_row(f"K11 {label}", lambda x=x: tm.bitonic_sort_cuda(x),
                 lambda x=x: tm.bitonic_sort_torch(x), 8 * n,
                 n * math.ceil(math.log2(n)), f"{n} keys",
                 lib=lambda x=x: torch.sort(x), lib_name="torch.sort")
    time_row("K11 merge_topk (16, 128)", lambda: tm.merge_topk(c16, 128),
             lambda: tm.bitonic_sort_torch(c16.reshape(-1))[:128], 8 * c16.numel(),
             c16.numel() * math.ceil(math.log2(c16.numel())), "2048 candidates",
             lib=lambda: torch.sort(c16.reshape(-1)).values[:128],
             lib_name="torch.sort")

    modes, _, wl_s = static_args(0, main_batch, MAIN_WINDOW)
    a4 = modes["K4s"][2]
    s_valid = (a4[0] != INVALID_DOC).long().sum(1)
    s_joins = a4[4].long().sum(1)
    s_slots = (MAIN_Q * MAIN_WINDOW + int(s_valid.sum()) * 2
               + int(s_valid[a4[5] >= 0].sum()))
    s_small = sum(x.numel() * 4 for x in a4[7:10]) + 4 * MAIN_Q * (1 + MAIN_T)
    probe_s = probed_postings(*a4[7:10], TILE)
    pk_b, pk_blk = probe_block_cost(*a4[7:10], TILE, meta_host[0])
    ops_s = int((s_valid * s_joins).sum()) * math.ceil(math.log2(MAIN_WINDOW + TILE))
    out_s = MAIN_Q * MAIN_WINDOW * 4
    b7_s = modes["K7s"][2][8].long().cpu().numpy()
    pm7_s = table_probe_cost(wl_s.desc, wl_s.n_items, b7_s, 3, TILE)
    pm7p_b, pm7p_blk = table_probe_cost(wl_s.desc, wl_s.n_items, b7_s, 3, TILE,
                                        meta_host[0])
    tbl_s = 32 * wl_s.n_items + 4 * (wl_s.group_heads().size)
    for key, n_bytes, n_ops, extra in (
        ("K4s", s_small + s_slots * 4 + probe_s * 4 + out_s, ops_s,
         f"probed {probe_s} postings"),
        ("K4ps", s_small + s_slots * 4 + pk_b + out_s, ops_s + 4 * BLOCK * pk_blk,
         f"probes {pk_blk} blocks {pk_b} bytes"),
        ("K7s", tbl_s + s_slots * 4 + pm7_s * 4 + out_s, ops_s,
         f"probed {pm7_s} postings, {wl_s.n_items} descriptor rows"),
        ("K7ps", tbl_s + s_slots * 4 + pm7p_b + out_s, ops_s + 4 * BLOCK * pm7p_blk,
         f"probes {pm7p_blk} blocks {pm7p_b} bytes, {wl_s.n_items} rows"),
    ):
        cuda_fn, plain_fn, a, kw = modes[key]
        time_row(key, lambda c=cuda_fn, a=a, kw=kw: c(*a, **kw),
                 lambda p=plain_fn, a=a, kw=kw: p(*a, **kw), n_bytes, n_ops,
                 f"static mode, Q={MAIN_Q}, T={MAIN_T}, W={MAIN_WINDOW}, shard 0, {extra}",
                 kernel={"K4s": "K4", "K4ps": "K4p", "K7s": "K7", "K7ps": "K7p"}[key])
    _, pad_batch, pad_live = live_cases(main_batch)[1]
    for mix, b, live in (("all live", main_batch, None),
                         (f"{int(pad_live.sum())} of {MAIN_Q} live", pad_batch, pad_live)):
        modes_l = static_args(0, b, MAIN_WINDOW, live_q=live)[0]
        log(f"[times] static modes, device ms beside the dense twin ({mix}; slave 0, "
            f"Q={MAIN_Q}, T={MAIN_T}, W={MAIN_WINDOW}): " + ", ".join(
                f"{key} {device_ms(lambda m=modes_l[key]: m[0](*m[2], **m[3]), kernel=kern):.5f}"
                f" vs {twin} "
                f"{device_ms(lambda m=modes_l[twin]: m[0](*m[2], **m[3]), kernel=tkern):.5f}"
                for key, kern, twin, tkern in (("K7s", "K7", "K4s", "K4"),
                                               ("K7ps", "K7p", "K4ps", "K4p")))
            + f" on {smi}")

    # the staged path against the streamed one per batch, interleaved
    def seq(b, backend, deltas_):
        return sequential_reference(raw_shards, b, ns=NS, k=k_all, window=MAIN_WINDOW,
                                    deltas=deltas_, backend=backend)

    st_cells = {}
    for cell, deltas_ in (("static", None), ("fill 1.0", p_views[1.0])):
        for backend in ("kernel", "kernel_staged"):
            for b in batches[:2]:
                seq(b, backend, deltas_)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for b in batches[:4]:
                    seq(b, backend, deltas_)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            kern = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kern) / 1e6
            log(f"[trace] sequential_reference, {backend} ({cell}): "
                f"{sum(e.count for e in kern) / 4:.1f} device ops and "
                f"{busy / 4 * 1e3:.3f} ms of device time per batch, busy share "
                f"{busy / wall:.4f} of {wall * 1e3:.3f} ms traced; top: " + "; ".join(
                    f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:4]))
        streamed, staged = [], []
        for _ in range(3):
            for b in batches:
                for backend, out in (("kernel", streamed), ("kernel_staged", staged)):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    seq(b, backend, deltas_)
                    torch.cuda.synchronize()
                    out.append((time.perf_counter() - t) * 1e3)
        ratio = np.array(streamed) / np.array(staged)
        st_cells[cell] = (float(np.median(streamed)), float(np.median(staged)),
                          float(np.median(ratio)))
        log(f"[times] staged vs streamed per batch of {MAIN_Q} ({cell}; "
            f"sequential_reference over {NS} slaves, host clock around synchronize, "
            f"{len(ratio)} interleaved pairs): streamed median {st_cells[cell][0]:.3f} ms, "
            f"staged median {st_cells[cell][1]:.3f} ms, median streamed/staged ratio "
            f"{st_cells[cell][2]:.4f} (quartiles {np.percentile(ratio, 25):.4f} / "
            f"{np.percentile(ratio, 75):.4f}) on {smi}")

    # an updatable staged service: a cached query, a mutation, a fresh answer
    svc_st = SearchService(sharded, meta, writer=p_writer, backend="kernel_staged",
                           **main_kw)
    reset_launches()
    st_got = serve(svc_st, queries[:MAIN_Q], ks[:MAIN_Q])
    ex = executed_batches(svc_st)
    if launches_now() != {**no_launch, "K9": NS * ex}:
        raise AssertionError(f"staged service: launches {launches_now()}")
    q = next(q for q, h in zip(queries, st_got) if h[0] and h[1] > 1)
    first = svc_st.search([q])[0]
    stale0 = svc_st.stats()["cache"]["stale"]
    victim = next(d for d in first.docids
                  if d not in p_touched and d not in p_writer.delta_doc_ids)
    svc_st.delete([victim])
    after = svc_st.search([q])[0]
    fresh = SearchService(sharded, meta, writer=p_writer, backend="kernel_staged",
                          cache_size=0, **main_kw).search([q])[0]
    if (svc_st.stats()["cache"]["stale"] != stale0 + 1 or after != fresh
            or victim in after.docids):
        raise AssertionError("staged service: stale cache check failed")
    log(f"[staged] updatable SearchService(backend='kernel_staged'): {MAIN_Q} queries, "
        f"K9 {NS} launches a batch and nothing else; after deleting doc {victim} the "
        f"cached query {q} was recomputed (stale {stale0} -> {stale0 + 1}), equal to a "
        f"fresh service, n_hits {first.n_hits} -> {after.n_hits}")
    phase_end("13 staged")

    # ------------------------------------------------------------ 14. flash
    # K12 at the reference test's shapes and at two configurations' full
    # attention width: phi4-mini-3.8b (H 24, KV 8, hd 128) and gemma-2b (H 8,
    # KV 1, hd 256).  Products in full float32 for the plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    flash_tol = {f32: 2e-5, bf16: 2e-2}
    gen = torch.Generator().manual_seed(args.seed)

    def qkv(b, s, t, h, kv, hd, dtype):
        return tuple(torch.randn(shape, generator=gen).to(dev, dtype)
                     for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))

    phi4 = (1, 4096, 4096, 24, 8, 128)
    gemma = (1, 2048, 2048, 8, 1, 256)
    flash_cases = [  # (label, (B, S, T, H, KV, hd), q_chunk, k_chunk, causal, dtype)
        *((f"test {c[:6]} causal {causal}", c[:6], c[6], c[7], causal, f32)
          for c in ((1, 256, 256, 4, 4, 64, 128, 128), (2, 256, 256, 4, 2, 64, 128, 128),
                    (1, 256, 256, 4, 1, 64, 128, 128), (1, 512, 512, 2, 2, 128, 128, 256),
                    (1, 128, 384, 2, 2, 64, 128, 128))
          for causal in (True, False)),
        ("test bf16", (1, 256, 256, 2, 2, 64), 128, 128, True, bf16),
        ("test hd 128, chunks 128 x 256, bf16", (1, 512, 512, 2, 2, 128), 128, 256,
         True, bf16),
        ("test hd 64, T > S, non-causal, bf16", (1, 128, 384, 2, 2, 64), 128, 128,
         False, bf16),
        ("ragged: S = T = 192, chunks 64 (a 128-row q tile past S, a 128-key tile "
         "past T), bf16", (1, 192, 192, 4, 2, 128), 64, 64, True, bf16),
        ("ragged hd 256: S = 64, T = 96, chunks (64, 32), bf16", (1, 64, 96, 2, 1, 256),
         64, 32, False, bf16),
        ("ragged hd 64, GQA 3: S = T = 192, chunks 64, bf16", (1, 192, 192, 6, 2, 64),
         64, 64, True, bf16),
        *((f"ragged float32: {label}", shape, cq, ck, causal, f32)
          for label, shape, cq, ck, causal in (
              ("S = T = 192, chunks 64 (a 128-row q tile past S)",
               (1, 192, 192, 4, 2, 128), 64, 64, True),
              ("hd 256, S = 64, T = 96, chunks (64, 32)", (1, 64, 96, 2, 1, 256), 64, 32,
               False),
              ("hd 64, GQA 3, S = T = 192, chunks 64", (1, 192, 192, 6, 2, 64), 64, 64,
               True),
              ("hd 256, GQA 8, T > S, non-causal", (1, 256, 384, 8, 1, 256), 128, 128,
               False))),
        ("phi4-mini f32", phi4, 128, 128, True, f32),
        ("phi4-mini bf16", phi4, 128, 128, True, bf16),
        ("gemma-2b f32", gemma, 128, 128, True, f32),
        ("gemma-2b bf16", gemma, 128, 128, True, bf16),
        ("phi4-mini heads, chunks 128 x 256", (1, 1024, 1024, 24, 8, 128), 128, 256,
         True, f32),
        ("phi4-mini heads, T > S, non-causal", (1, 1024, 2048, 24, 8, 128), 128, 128,
         False, f32),
        ("phi4-mini heads, T > S, non-causal, bf16", (1, 1024, 2048, 24, 8, 128), 128,
         128, False, bf16),
    ]
    flash_in = [qkv(*shape, dtype) for _, shape, _, _, _, dtype in flash_cases]
    reset_launches()
    flash_out = [fa.flash_attention_fwd(q, k, v, causal=causal, q_chunk=cq, k_chunk=ck)
                 for (_, _, cq, ck, causal, _), (q, k, v) in zip(flash_cases, flash_in)]
    flash_launches = launches_now()
    if flash_launches != {**no_launch, "K12": len(flash_cases)}:
        raise AssertionError(f"flash: launches {flash_launches}, expected one K12 "
                             f"a call ({len(flash_cases)})")
    torch.cuda.synchronize()
    flash_err = {f32: 0.0, bf16: 0.0}
    row_rel = 0.0          # the bf16 cases' largest row-relative error
    flash_bad = []         # every case is read before a failure is raised
    for (label, shape, cq, ck, causal, dtype), (q, k, v), got in zip(
            flash_cases, flash_in, flash_out):
        errs = []
        for name, want in (
                ("plain", fa.flash_attention_fwd_torch(q, k, v, causal=causal,
                                                       q_chunk=cq, k_chunk=ck)),
                ("ref", fa.flash_attention_ref(q, k, v, causal=causal))):
            if got.shape != want.shape or got.dtype != want.dtype \
                    or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"K12 {label}: {got.dtype} {tuple(got.shape)} vs "
                                     f"{want.dtype} {tuple(want.shape)} or not finite")
            g, w = got.float(), want.float()
            err = float((g - w).abs().max())
            max_err["K12"] = max(max_err["K12"], err)
            flash_err[dtype] = max(flash_err[dtype], err)
            errs.append(f"{name} {err:.3g}")
            tol = flash_tol[dtype]
            if not torch.allclose(g, w, rtol=tol, atol=tol):
                flash_bad.append(f"{label}: max abs err vs {name} {err} beyond "
                                 f"rtol = atol = {tol}")
            if dtype == bf16:
                rr = fa.max_row_rel_err(g, w)
                row_rel = max(row_rel, rr)
                errs.append(f"row-relative {rr:.4f}")
                if rr >= fa.BF16_ROW_REL_TOL:
                    flash_bad.append(f"{label}: row-relative err vs {name} {rr} beyond "
                                     f"{fa.BF16_ROW_REL_TOL}")
            del want, g, w
        log(f"[flash] K12 {label} {shape} chunks ({cq}, {ck}) causal {causal} "
            f"{str(dtype)[6:]}: max abs err " + ", ".join(errs) + " (bounds rtol = "
            f"atol = {flash_tol[dtype]:g}" + (f", row-relative {fa.BF16_ROW_REL_TOL:g}"
                                             if dtype == bf16 else "") + ")")
    if flash_bad:
        raise AssertionError("K12: " + "; ".join(flash_bad))

    # the bounds would catch a ring fault in a long causal row: the last q
    # tile with one k/v tile of mid-row left out, or with V read from the
    # slot's previous tile, held against the sound rows (bf16: the
    # row-relative bound; float32: rtol = atol = 2e-5, the float32 kernel's
    # tiles and two slots)
    def last_rows(q, k, v, dropped=None):
        S, hd, G = q.shape[1], q.shape[3], q.shape[2] // k.shape[2]
        qf = q[:, S - 128:].float().transpose(1, 2)
        kf, vf = (x.float().repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))
        sc = (qf @ kf.transpose(-1, -2)) / math.sqrt(hd)
        pos = torch.arange(S, device=q.device)
        sc = sc.masked_fill(pos[None, :] > pos[S - 128:, None], fa.NEG_INF)
        if dropped is not None:
            sc[..., dropped] = -torch.inf
        return (torch.softmax(sc, -1) @ vf).transpose(1, 2).to(q.dtype)

    for (label, shape, _, _, causal, dtype), (q, k, v) in zip(flash_cases, flash_in):
        if label not in ("phi4-mini bf16", "gemma-2b bf16", "phi4-mini f32",
                         "gemma-2b f32"):
            continue
        if dtype == bf16:
            bk, stages = (128, 3) if shape[5] <= 128 else (64, 2)
        else:
            bk, stages = fa.TF32_TILES[shape[5]][1], 2
        j = shape[2] // bk // 2
        sound = last_rows(q, k, v)
        v2 = v.clone()
        v2[:, j * bk:(j + 1) * bk] = v[:, (j - stages) * bk:(j - stages + 1) * bk]
        bad_rows = {"dropped": last_rows(q, k, v, slice(j * bk, (j + 1) * bk)),
                    "wrong slot": last_rows(q, k, v2)}
        if dtype == bf16:
            faults = {k_: fa.max_row_rel_err(x, sound) for k_, x in bad_rows.items()}
            caught = min(faults.values()) > fa.BF16_ROW_REL_TOL
            bound = (f"row-relative bound {fa.BF16_ROW_REL_TOL:g}, largest sound "
                     f"reading {row_rel:.4f}")
        else:
            faults = {k_: float((x - sound).abs().max()) for k_, x in bad_rows.items()}
            caught = not any(torch.allclose(x, sound, rtol=2e-5, atol=2e-5)
                             for x in bad_rows.values())
            bound = (f"rtol = atol = 2e-5, largest sound error "
                     f"{flash_err[f32]:.3g}")
        if not caught:
            raise AssertionError(f"K12 {label}: an emulated ring fault reads "
                                 f"{faults}, within the bound")
        log(f"[flash] K12 {label}: an emulated fault in k/v tile {j} of {bk} keys "
            f"({stages} slots) for the last 128 rows reads "
            + ("row-relative " if dtype == bf16 else "max abs ") + ", ".join(
                f"{k_} {x:.4g}" for k_, x in faults.items()) + f" ({bound})")
        del sound, v2, bad_rows
    del flash_out, flash_in
    log(f"[flash] launches {flash_launches['K12']} K12 for {len(flash_cases)} "
        f"flash_attention_fwd calls; max abs err float32 {flash_err[f32]:.3g}, "
        f"bfloat16 {flash_err[bf16]:.3g}; largest bf16 row-relative err {row_rel:.4f}")

    # the bf16 kernel runs on the tensor cores: HGMMA in its SASS
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            hgmma[fn] = 0
        elif fn is not None and "HGMMA" in line:
            hgmma[fn] += 1
    for kname in kernel_names("K12"):
        fns = {f: c for f, c in hgmma.items() if kname in f}
        if len(fns) != 3 or min(fns.values()) == 0:
            raise AssertionError(f"K12: no HGMMA in {kname}'s SASS at some head width: "
                                 f"{hgmma}")
    log("[flash] HGMMA instructions in the built K12 library's SASS (cuobjdump -sass): "
        + "; ".join(f"{f} {c}" for f, c in hgmma.items()))

    flash_rows = {}
    for config, shape in (("phi4-mini", phi4), ("gemma-2b", gemma)):
        b_, s_, t_, h_, kv_, hd_ = shape
        # float32: held to the split-TF32 bound (three TF32 products a
        # product), the CUDA-core float32 bound beside it
        for dtype, peak in ((f32, TF32_FLOPS_PER_S / 3), (bf16, BF16_FLOPS_PER_S)):
            q, k, v = qkv(*shape, dtype)
            run = lambda: fa.flash_attention_fwd_cuda(q, k, v)  # noqa: E731
            plain = lambda: fa.flash_attention_fwd_torch(q, k, v)  # noqa: E731
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
            sdpa_err = float((sdpa().transpose(1, 2).float() - run().float()).abs().max())
            ms, dev_ms = cuda_ms(run, reps=20, warmup=3), device_ms(run, reps=10)
            dev_own = device_ms(run, reps=10, kernel="K12")
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            plain_dev = device_ms(plain, reps=2)
            lib_ms, lib_dev = cuda_ms(sdpa, reps=20, warmup=3), device_ms(sdpa, reps=10)
            n_bytes = 2 * (q.numel() + k.numel() + v.numel()) * q.element_size()
            flops = 4 * b_ * h_ * s_ * t_ * hd_ // 2
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
            bound, by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                                     else "operations")
            flash_rows[config, dtype] = (ms, plain_ms, bound, by, lib_ms)

            def dev_reading(x):
                # a profiler total below the bound cannot be the kernel's time
                return ("not measured (no device event)" if x == 0 else
                        f"unusable (the profiler's {x:.4f} ms is below the bound)"
                        if x < bound else f"{x:.4f} ms")

            core = (f"; CUDA-core float32 bound "
                    f"{max(t_bytes, flops / FP32_FLOPS_PER_S) * 1e3:.4f} ms "
                    f"(K12 / it {ms / (max(t_bytes, flops / FP32_FLOPS_PER_S) * 1e3):.2f}x)"
                    if dtype == f32 else "")
            log(f"[times] K12 {config} {shape} causal {str(dtype)[6:]}: {ms:.4f} "
                f"ms/launch (CUDA events), device {dev_reading(dev_ms)} (profiler; "
                f"the kernel's own events: {dev_reading(dev_own)}); "
                f"plain {plain_ms:.4f} ms (device {dev_reading(plain_dev)}); SDPA "
                f"(enable_gqa, same dtype) {lib_ms:.4f} ms (device "
                f"{dev_reading(lib_dev)}; max abs diff from K12 {sdpa_err:.3g}); bound "
                f"{bound:.4f} ms ({by}: {flops} flops at {peak / 1e12:.0f} TFLOP/s"
                + (" (495 split three ways)" if dtype == f32 else "")
                + f", {n_bytes} bytes at 3.35 TB/s){core}; K12 / SDPA "
                f"{ms / lib_ms:.2f}x, K12 / bound {ms / bound:.2f}x on {smi}")
            del q, k, v, qt, kt, vt
    phase_end("14 flash")

    # ------------------------------------------------------------ 15. ingest
    # Multi-master ingest on phase 3's index: phase 8's stream split across 4
    # ingest threads into a ShardedDeltaWriter's queues, one drain worker a
    # shard, the main thread serving meanwhile.
    torch.cuda.reset_peak_memory_stats()
    base_n, vocab = corpus.n_docs, meta.vocab_size

    def capacity_safe_ops(stream, n_docs, meta_, cap, ns):
        """The stream's inserts and its deletes and updates of base docs, as
        the longest prefix whose delta lists cannot pass ``cap`` in any
        interleaving: per (shard, term) every insert (its shard is known
        only at apply time) plus the base docs of that shard ever given the
        term."""
        worst = np.zeros((ns, meta_.n_terms), np.int64)
        pairs, sites_now, kept = set(), {}, []
        for m in stream:
            if m.op != "insert" and m.docid >= n_docs:
                continue
            add = np.zeros_like(worst)
            if m.op != "delete":
                site = m.site if m.site is not None else sites_now.get(m.docid)
                if site is None:
                    site = int(corpus.doc_site[m.docid])
                terms = set(np.unique(np.asarray(m.terms)).tolist())
                if meta_.include_site_terms:
                    terms.add(meta_.vocab_size + site)
                if m.op == "insert":
                    add[:, sorted(terms)] = 1
                else:
                    new = [t for t in terms if (m.docid, t) not in pairs]
                    add[m.docid % ns, new] = 1
            if ((worst + add) > cap).any():
                break
            worst += add
            if m.op == "update":
                pairs.update((m.docid, t) for t in terms)
                if m.site is not None:
                    sites_now[m.docid] = m.site
            kept.append(m)
        return kept

    ing_ops = capacity_safe_ops(muts, base_n, meta, TERM_CAPACITY, NS)
    n_threads = 4
    owner = {}
    per_thread = [[] for _ in range(n_threads)]
    for i, m in enumerate(ing_ops):
        tid = i % n_threads if m.op == "insert" else owner.setdefault(
            m.docid, (m.docid // NS) % n_threads)
        per_thread[tid].append(m)
    # deliberate conflicts: an unknown docID, and an update of a doc its own
    # thread deleted before (same home queue, so always after the delete)
    n_conflicts = 0
    for tid, mine in enumerate(per_thread):
        mine.append(Mutation("delete", 10**9 + tid, None, None))
        dead = [m.docid for m in mine if m.op == "delete" and m.docid < base_n]
        n_conflicts += 1
        if dead:
            mine.append(Mutation("update", dead[0], np.array([1], np.int32), None))
            n_conflicts += 1
    n_submitted = sum(len(m) for m in per_thread)
    ing_kinds = {k: sum(m.op == k for m in ing_ops) for k in ("insert", "delete", "update")}

    class PublishedWriter(ShardedDeltaWriter):
        """Keeps the snapshot of the last publish: the one the service's
        batch reads (the service publishes from this thread only)."""

        def device_delta(self):
            self.last_snapshot = super().device_delta()
            self.last_stamp = self._snapshot_version
            return self.last_snapshot

    ing_reg = MetricsRegistry()
    t0 = time.perf_counter()
    w = PublishedWriter(corpus, meta, NS, term_capacity=TERM_CAPACITY,
                        doc_headroom=DOC_HEADROOM, device=dev, registry=ing_reg)
    log(f"[ingest] ShardedDeltaWriter(term_capacity={TERM_CAPACITY}, doc_headroom="
        f"{DOC_HEADROOM}) over the {base_n}-page corpus in "
        f"{time.perf_counter() - t0:.2f} s; phase 8's stream cut to the {len(ing_ops)} "
        f"ops ({ing_kinds}) that cannot fill a list in any order, split across "
        f"{n_threads} ingest threads (inserts round-robin, deletes and updates by "
        f"doc), plus {n_conflicts} deliberate conflicts: {n_submitted} submissions")

    def submit(m):
        if m.op == "insert":
            w.submit_insert(m.terms, m.site)
        elif m.op == "delete":
            w.submit_delete(m.docid)
        else:
            w.submit_update(m.docid, m.terms, m.site)

    submitted_all = threading.Event()
    n_done, applied_by, errs = [0], [0] * NS, []

    def ingest(tid):
        try:
            for m in per_thread[tid]:
                submit(m)
                time.sleep(0.025)   # arrivals spread over the serving window
        except BaseException as e:  # surfaced in the main thread
            errs.append(e)
        finally:
            with count_lock:
                n_done[0] += 1
                if n_done[0] == n_threads:
                    submitted_all.set()

    def drainer(s):
        try:
            while True:
                done = submitted_all.is_set()
                applied_by[s] += w.drain(s)
                if done and w.queue_depth(s) == 0:
                    return
                time.sleep(0.0005)
        except BaseException as e:
            errs.append(e)

    count_lock = threading.Lock()
    threads = ([threading.Thread(target=ingest, args=(i,)) for i in range(n_threads)]
               + [threading.Thread(target=drainer, args=(s,)) for s in range(NS)])
    svc_i = SearchService(sharded, meta, writer=w, **main_kw)
    orig_exec = svc_i.scheduler.executor
    checked, during, snaps = [0], [0], set()

    def checked_exec(qs, t_max, k, set_id):
        """The kernel batch, then backend="torch" on the very snapshot it
        read (an immutable value, however far ingest has moved since)."""
        during[0] += any(t.is_alive() for t in threads)
        hits = orig_exec(qs, t_max, k, set_id)
        snap = w.last_snapshot
        snaps.add(w.last_stamp)
        want = distributed_query_topk(
            sharded, make_query_batch(qs, t_max=t_max, meta=meta, device=dev), snap,
            ns=NS, k=k, window=MAIN_WINDOW, backend="torch")
        w_docs, w_hits = want.docids.cpu().numpy(), want.n_hits.cpu().numpy()
        for h, row, n in zip(hits, w_docs, w_hits):
            if h.docids != [int(d) for d in row if d != INVALID_DOC] or h.n_hits != n:
                raise AssertionError("ingest: a served batch differs from "
                                     "backend='torch' on its snapshot")
        checked[0] += 1
        return hits

    svc_i.scheduler.executor = checked_exec
    reset_launches()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    rounds = 0
    while rounds == 0 or any(t.is_alive() for t in threads):
        serve(svc_i, queries, ks)
        rounds += 1
    for t in threads:
        t.join()
    t_ing = time.perf_counter() - t0
    if errs:
        raise errs[0]
    ing_counts = launches_now()
    ex = executed_batches(svc_i)
    want_counts = {**no_launch, "K2": int(math.log2(NS)) * ex, "K3": NS * ex,
                   "K4": NS * ex}
    if ing_counts != want_counts or ex == 0 or checked[0] != ex:
        raise AssertionError(f"ingest: launches {ing_counts} vs {want_counts}, "
                             f"{checked[0]} checked of {ex} executed")
    applied = sum(applied_by)
    conflicts = ing_reg.counter("odys_ingest_conflicts_total").value
    log(f"[ingest] {rounds} rounds of the {len(queries)} queries served while ingest "
        f"ran ({t_ing:.2f} s): {ex} executed batches over {len(snaps)} distinct "
        f"snapshots ({during[0]} batches started while ingest threads were alive), each equal "
        f"to backend='torch' on the snapshot it read; launches {ing_counts}")
    if sum(w.version.seqs) != applied or applied + conflicts != n_submitted \
            or conflicts != n_conflicts or w.queue_depth() != 0:
        raise AssertionError(f"ingest: seqs {w.version}, applied {applied}, "
                             f"conflicts {conflicts} (expected {n_conflicts}), "
                             f"submitted {n_submitted}")

    # the published snapshot against a sequential DeltaWriter oracle: the
    # concurrent run's inserts in docID order, then each doc's own ops in the
    # order its thread submitted them
    t0 = time.perf_counter()
    oracle = DeltaWriter(corpus, meta, NS, term_capacity=TERM_CAPACITY,
                         doc_headroom=DOC_HEADROOM, device=dev)
    for gid in range(base_n, w.n_docs):
        terms = [int(t) for t in w._terms_of(gid)]
        oracle.insert_docs([(terms or [0], w._site_of(gid))])
        if not terms:
            oracle.delete_docs([gid])
    for mine in per_thread:
        for m in mine:
            if m.op == "insert":
                continue
            try:
                if m.op == "delete":
                    oracle.delete_docs([m.docid])
                else:
                    oracle.update_docs([(m.docid, m.terms, m.site)])
            except KeyError:
                pass
    got_snap, want_snap = w.device_delta(), oracle.device_delta()
    for name, g, r in zip(got_snap._fields, got_snap, want_snap):
        if not torch.equal(g, r):
            raise AssertionError(f"ingest: snapshot field {name} differs from the "
                                 f"sequential oracle")
    log(f"[ingest] after the joins: {w.n_docs - base_n} inserts, {applied} ops applied "
        f"= sum(version.seqs) of {w.version}; {int(conflicts)} dropped = "
        f"odys_ingest_conflicts_total; the snapshot equals the sequential "
        f"DeltaWriter oracle field by field (torch.equal; oracle "
        f"{time.perf_counter() - t0:.2f} s)")

    # the 512 queries on the final snapshot
    reset_launches()
    svc_f = SearchService(sharded, meta, writer=w, **main_kw)
    f_got = serve(svc_f, queries, ks)
    f_counts, ex = launches_now(), executed_batches(svc_f)
    want_counts = {**no_launch, "K2": int(math.log2(NS)) * ex, "K3": NS * ex,
                   "K4": NS * ex}
    if f_counts != want_counts or ex == 0:
        raise AssertionError(f"ingest: launches {f_counts} vs {want_counts}")
    if f_got != serve(SearchService(sharded, meta, writer=w, backend="torch",
                                    **main_kw), queries, ks):
        raise AssertionError("ingest: final hits differ from backend='torch'")
    log(f"[ingest] the {len(queries)} queries on the final snapshot equal "
        f"backend='torch'; K3 = K4 = {NS} and K2 = {int(math.log2(NS))} launches a "
        f"batch over {ex} batches ({f_counts})")

    # a query cached before a mutation on a different shard than the last
    # one is recomputed: the delete moves only that shard's seq
    w.insert_docs([([vocab - 1], meta.n_sites - 1)])
    last_shard = (w.n_docs - 1) % NS
    q, first = next((q, h) for q, h in zip(
        queries, svc_f.search(queries)) if h.n_hits > 1 and any(
            d % NS != last_shard and d not in w.delta_doc_ids for d in h.docids))
    victim = next(d for d in first.docids
                  if d % NS != last_shard and d not in w.delta_doc_ids)
    stale0 = svc_f.stats()["cache"]["stale"]
    v_before = w.version
    w.delete_docs([victim])
    moved = [s for s in range(NS) if w.version.seqs[s] != v_before.seqs[s]]
    after = svc_f.search([q])[0]
    fresh = SearchService(sharded, meta, writer=w, backend="torch",
                          **main_kw).search([q])[0]
    if (moved != [victim % NS] or svc_f.stats()["cache"]["stale"] != stale0 + 1
            or after != fresh or victim in after.docids
            or after.n_hits != first.n_hits - 1):
        raise AssertionError(f"ingest: stale cache check failed ({moved}, "
                             f"{first.n_hits} -> {after.n_hits})")
    log(f"[ingest] query {q} cached at {v_before} (the last mutation on shard "
        f"{last_shard}); deleting doc {victim} moved shard {moved[0]} alone, to "
        f"{w.version}, and the query was recomputed (stale {stale0} -> "
        f"{stale0 + 1}), n_hits {first.n_hits} -> {after.n_hits}, equal to "
        f"backend='torch'")

    # publish seconds: the base writer's full copy against the sharded
    # writer's copy of the shards that moved
    def publish_s(writer, n_docs):
        out = []
        for _ in range(3):
            writer.insert_docs([([vocab - 1], meta.n_sites - 1)] * n_docs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            writer.device_delta()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return float(np.median(out)), out

    pub = {"base DeltaWriter": publish_s(oracle, 1),
           "sharded, 1 of 4 shards moved": publish_s(w, 1),
           "sharded, 4 of 4 shards moved": publish_s(w, NS)}
    log("[ingest] publish seconds (device_delta(), host clock around synchronize, "
        "median of 3): " + "; ".join(f"{k} {v[0]:.4f} s {[round(x, 4) for x in v[1]]}"
                                     for k, v in pub.items()) + f" on {smi}")

    # ingest ops/s with the thread-safe calls, 1 thread against 4
    def apply_direct(wr, ops_):
        for m in ops_:
            try:
                if m.op == "insert":
                    wr.insert_docs([(m.terms, m.site)])
                elif m.op == "delete":
                    wr.delete_docs([m.docid])
                else:
                    wr.update_docs([(m.docid, m.terms, m.site)])
            except KeyError:
                pass

    ops_s = {}
    for nt in (1, n_threads):
        wr = ShardedDeltaWriter(corpus, meta, NS, term_capacity=TERM_CAPACITY,
                                doc_headroom=DOC_HEADROOM, device=dev)
        parts = ([sum(per_thread, [])] if nt == 1 else per_thread)
        ths = [threading.Thread(target=apply_direct, args=(wr, p)) for p in parts]
        t = time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        ops_s[nt] = n_submitted / (time.perf_counter() - t)
        if sum(wr.version.seqs) != n_submitted - n_conflicts:
            raise AssertionError(f"ingest: {nt} threads applied {wr.version}")
        del wr
    log(f"[ingest] {n_submitted} ops through insert_docs/delete_docs/update_docs "
        f"(host numpy under the GIL): {ops_s[1]:.1f} ops/s on 1 thread, "
        f"{ops_s[n_threads]:.1f} ops/s on {n_threads}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes (index {sharded.nbytes()}, "
        f"snapshot {w.device_delta().nbytes()})")
    del w, oracle, svc_i, svc_f, got_snap, want_snap

    # compaction racing two insert threads on the 3000-page corpus
    sw = ShardedDeltaWriter(small, s_meta, NS, term_capacity=512, doc_headroom=2048,
                            device=dev)
    svc_c = SearchService(s_idx, s_meta, writer=sw, **main_kw)
    stop = threading.Event()
    landed = [[], []]

    def insert_loop(tid):
        try:
            i = 0
            while not stop.is_set():
                term = (i * 7 + tid) % s_meta.vocab_size
                (gid,) = sw.insert_docs([([term], tid % s_meta.n_sites)])
                landed[tid].append((gid, term, sw.version.epoch))
                i += 1
                time.sleep(0.0002)
        except DeltaFullError:
            pass
        except BaseException as e:
            errs.append(e)

    ths = [threading.Thread(target=insert_loop, args=(i,)) for i in range(2)]
    for th in ths:
        th.start()
    t0 = time.perf_counter()
    try:
        for i in range(3):
            # let inserts land in every generation before it is folded
            while sum(map(len, landed)) < 50 * (i + 1) and any(
                    th.is_alive() for th in ths):
                time.sleep(0.001)
            svc_c.compact(verify=True)
    finally:
        stop.set()
        for th in ths:
            th.join()
    t_c = time.perf_counter() - t0
    if errs:
        raise errs[0]
    ins = sorted(x for lst in landed for x in lst)
    mutated = sw.mutated_corpus()
    if (sw.version.epoch != 3 or sw.n_docs != small.n_docs + len(ins)
            or [g for g, _, _ in ins] != list(range(small.n_docs, sw.n_docs))
            or any(list(mutated.terms_of(g)) != [t] for g, t, _ in ins)):
        raise AssertionError(f"ingest: compaction race lost or doubled an insert "
                             f"({sw.version}, {sw.n_docs}, {len(ins)})")
    per_epoch = [sum(e == ep for _, _, e in ins) for ep in range(4)]
    c_q = s_q + [([t], None) for t in sorted({t for _, t, _ in ins})[:32]]
    c_ks = s_ks + [10] * (len(c_q) - len(s_q))
    c_got = serve(svc_c, c_q, c_ks)
    c_truth = brute_force_topk(mutated, c_q, mutated.n_docs)
    if c_got != [(t[:k], len(t)) for t, k in zip(c_truth, c_ks)]:
        raise AssertionError("ingest: hits after the raced compactions differ from "
                             "brute force")
    log(f"[ingest] 3 x compact(verify=True) in {t_c:.2f} s raced 2 insert threads on "
        f"the 3000-page corpus: epoch {sw.version.epoch}, {len(ins)} inserts (by the "
        f"epoch they landed in: {per_epoch}), none lost or doubled; {len(c_q)} queries "
        f"equal brute force over the mutated corpus")
    phase_end("15 ingest")

    # ------------------------------------------------------------ 16. model
    # The paper's hybrid performance model calibrated on this card from the
    # static path (K1 in every slave, K2 in every merge), its projections,
    # and a Poisson replay through a health-aware two-set service (set 1
    # failed after a third of the trace, recovered after two thirds) with
    # the residual monitor as span sink.
    cal_widths = inspect.signature(
        calibrate_mod.fit_merge_constants).parameters["widths"].default
    cal_kw = dict(ns=NS, k_values=(10, 50, 1000), window=MAIN_WINDOW, t_max=MAIN_T,
                  q=MAIN_Q, reps=4, backend="kernel", merge="tournament",
                  seed=args.seed)
    merge_fit = []
    fit = calibrate_mod.fit_merge_constants
    # keep the fit's raw per-(k, w) times, which the calibration drops
    calibrate_mod.fit_merge_constants = lambda **kw: merge_fit.append(fit(**kw)) or merge_fit[-1]
    try:
        reset_launches()
        t0 = time.perf_counter()
        cal = calibrate_mod.calibrate_from_engine(sharded, meta, **cal_kw)
        t_cal = time.perf_counter() - t0
        cal_launches = launches_now()
    finally:
        calibrate_mod.fit_merge_constants = fit
    n_k, timed_calls = len(cal_kw["k_values"]), max(cal_kw["reps"], NS) + 1
    want_cal = {**no_launch,
                # each k: (reps + 1 warm-up) slave-phase calls and as many
                # master-path calls, NS K1 launches each
                "K1": n_k * 2 * timed_calls * NS,
                # the merge fit: (reps + 1) merges a (k, w); each master-path
                # call: log2(NS) tournament rounds
                "K2": n_k * len(cal_widths) * (cal_kw["reps"] + 1)
                      + n_k * timed_calls * int(math.log2(NS))}
    log(f"[model] calibrate_from_engine on phase 3's index ({NS} slaves of "
        f"{args.n_docs // NS} pages; {cal_kw}) in {t_cal:.2f} s; launches {cal_launches}, implied by the reps "
        f"and widths {want_cal} on {smi}")
    if cal_launches != want_cal or min(cal_launches["K1"], cal_launches["K2"]) == 0:
        raise AssertionError(f"model: calibration launches {cal_launches} != {want_cal}")
    t_cmp, t_base, raw = merge_fit[0]
    log(f"[model] merge fit (Formula (7), K2 on q={MAIN_Q} rows of w*k keys): "
        f"t_comparison {cal.t_comparison:.6e} s, t_base {cal.t_base:.6e} s; raw s "
        "per query: " + ", ".join(f"(k={k}, w={w}) {v:.6e}" for (k, w), v in raw.items())
        + f" on {smi}")
    log("[model] per k (s per query; st_slave sums the ns shards, which run in "
        "turn on one card): " + "; ".join(
            f"k={k}: st_slave {cal.st_slave[k]:.6e}, st_master {cal.st_master[k]:.6e}, "
            f"slave_max {cal.slave_max[k]:.6e}" for k in cal.st_slave) + f" on {smi}")
    log(f"[model] fitted MasterParams: {cal.master}")
    fitted = [cal.t_comparison, cal.t_base, cal.master.T_parent_proc,
              *cal.master.T_master_rpc.values(), *cal.st_slave.values(),
              *cal.st_master.values(), *cal.slave_max.values()]
    if not all(math.isfinite(v) and v > 0 for v in fitted) or (t_cmp, t_base) != (
            cal.t_comparison, cal.t_base):
        raise AssertionError(f"model: a fitted constant is not finite and positive: "
                             f"{fitted}")
    model = OdysPerfModel(master=cal.master, network=cal.network)
    lam_master = model.max_stable_load(engine_cluster(NS), SINGLE_10_ONLY)
    proj = {f: cal.projected_response(f * lam_master) for f in (0.25, 0.5, 0.75)}
    log(f"[model] projection from this card's fit on {smi}: master/network max "
        f"stable load (single top-10) "
        f"{lam_master:.1f} queries/s = {per_day(lam_master):.6e} queries/day; "
        f"projected response at 0.25 / 0.5 / 0.75 of it: " + " / ".join(
            f"{v * 1e3:.4f} ms" for v in proj.values())
        + f" (inf: past the slave tier's {cal.max_stable_load():.1f} queries/s); "
        f"whole-model stable load, slave tier included: single top-10 "
        f"{cal.max_stable_load():.1f} queries/s = "
        f"{per_day(cal.max_stable_load()):.6e} queries/day, default mix "
        f"{cal.max_stable_load(QUERY_MIX_DEFAULT):.1f} queries/s; projected "
        "response at 0.25 / 0.5 / 0.75 of the single top-10 one: " + " / ".join(
            f"{cal.projected_response(f * cal.max_stable_load()) * 1e3:.4f} ms"
            for f in (0.25, 0.5, 0.75)))

    # the replay: the 512 queries' terms and sites at the service's k (10;
    # a replayed trace carries no k), Poisson arrivals at half the two-set
    # model's stable load, batches formed within the time 32 arrivals take
    cal2 = cal.with_sets(2)
    lam = 0.5 * cal2.max_stable_load()
    k10 = [10] * len(queries)
    wait = MAIN_Q / lam
    reg16 = MetricsRegistry()
    prev_reg = set_registry(reg16)   # the engine's batch counters
    try:
        health = SetHealth.all_alive(2)
        svc16 = SearchService(sharded, meta, n_sets=2, set_health=health, cache_size=0,
                              max_wait=wait, registry=reg16, **main_kw)
        serve(svc16, queries[:MAIN_Q], k10[:MAIN_Q])    # warm, outside the window
        monitor = ModelResidualMonitor(cal2, batch_size=MAIN_Q, max_wait=wait,
                                       registry=reg16)
        router16 = svc16.scheduler.router
        route_inner, routed = router16.route, []

        def route_checked(n_real):
            s = route_inner(n_real)
            routed.append((s.sid, bool(health.alive[s.sid])))
            return s

        router16.route = route_checked
        n_q, folded = len(queries), [0]

        def sink(span):
            monitor.sink(span)
            folded[0] += 1
            if folded[0] == n_q // 3:
                health.fail(1)
            elif folded[0] == 2 * n_q // 3:
                health.recover(1)

        svc16.scheduler.span_sink = sink
        arrivals = np.cumsum(np.random.default_rng(args.seed).exponential(
            1.0 / lam, size=n_q))
        before = executed_batches(svc16)
        reset_launches()
        t0 = time.perf_counter()
        tickets = svc16.scheduler.replay(
            [(float(t), terms, site) for (terms, site), t in zip(queries, arrivals)])
        t_replay = time.perf_counter() - t0
        replay_launches = launches_now()
        executed = executed_batches(svc16) - before
        torch.cuda.synchronize()
        online = monitor.update()
        measured = float(np.mean([t.response_time for t in tickets]))
        dead = reg16.counter("odys_set_health_transitions_total", to="dead").value
        alive = reg16.counter("odys_set_health_transitions_total", to="alive").value
        residual = reg16.gauge("odys_model_residual").value
        by_set = {s: sum(1 for sid, _ in routed if sid == s) for s in (0, 1)}
        log(f"[model] replay: {n_q} queries at {lam:.1f} queries/s (0.5 x the two-set "
            f"model's stable load, single top-10), max_wait {wait * 1e3:.4f} ms, "
            f"{len(routed)} batches routed (set 0: {by_set[0]}, set 1: {by_set[1]}), "
            f"{t_replay:.2f} s of host time; launches {replay_launches}; set "
            f"transitions dead {dead:g} alive {alive:g}")
        log(f"[model] measured mean response {measured * 1e3:.4f} ms (virtual "
            f"arrivals, batch service on the wall clock); projected (Formula (17) + "
            f"formation) {online['projected'] * 1e3:.4f} ms at the monitor's "
            f"{online['lam']:.1f} queries/s; Formula (18) error {online['error']:.4f} "
            f"(odys_model_residual {residual:.4f}; not gated) on {smi}")
        if not all(t.done for t in tickets):
            raise AssertionError("model: a replayed ticket did not complete")
        if not all(ok for _, ok in routed) or 0 in by_set.values():
            raise AssertionError(f"model: a batch routed to a dead set, or a set got "
                                 f"none: {by_set}")
        if (dead, alive) != (1, 1):
            raise AssertionError(f"model: set transitions dead {dead} alive {alive}")
        if not math.isfinite(residual) or residual != online["error"]:
            raise AssertionError(f"model: odys_model_residual {residual}")
        if replay_launches != {**no_launch, "K1": NS * executed,
                               "K2": int(math.log2(NS)) * executed}:
            raise AssertionError(f"model: replay launches {replay_launches} for "
                                 f"{executed} batches")
        svc_t = SearchService(sharded, meta, backend="torch", cache_size=0, **main_kw)
        want16 = serve(svc_t, queries, k10)
        got16 = [(t.result.docids, t.result.n_hits) for t in tickets]
        if got16 != want16:
            bad = sum(g != w for g, w in zip(got16, want16))
            raise AssertionError(f"model: {bad} replayed hits differ from backend='torch'")
        log(f"[model] all {n_q} replayed hits equal backend='torch' on the card")
        # every set dead: dispatch refuses and the queue keeps its tickets
        health.fail(0)
        health.fail(1)
        held = [svc16.submit(terms, site) for terms, site in queries[:3]]
        try:
            svc16.drain()
        except RuntimeError as e:
            refused = str(e)
        else:
            raise AssertionError("model: dispatch with every set dead did not raise")
        if svc16.scheduler.pending() != 3 or any(t.done for t in held):
            raise AssertionError("model: the queue lost tickets with every set dead")
        health.recover(0)
        svc16.drain()
        if [(t.result.docids, t.result.n_hits) for t in held] != want16[:3]:
            raise AssertionError("model: held tickets differ after recovery")
        log(f"[model] every set dead: dispatch raised RuntimeError ({refused!r}), "
            f"3 tickets kept, served equal to backend='torch' after set 0 recovered")
        # a cached pass on the same registry (the cache's families)
        svc_c16 = SearchService(sharded, meta, cache_size=256, registry=reg16,
                                **main_kw)
        for _ in range(2):
            if serve(svc_c16, queries[:64], k10[:64]) != want16[:64]:
                raise AssertionError("model: cached pass differs from backend='torch'")
        prom = to_prometheus(reg16)
        doc = json.loads(dump_json(reg16))
        missing = [f for f, kind in REQUIRED_FAMILIES.items()
                   if doc["metrics"].get(f, {}).get("kind") != kind]
        phases = {s["labels"]["phase"] for s in doc["metrics"]["odys_phase_seconds"]["series"]}
        if missing or set(PHASES) - phases or "odys_phase_seconds_bucket" not in prom:
            raise AssertionError(f"model: exposition lacks {missing} "
                                 f"{set(PHASES) - phases}")
        log(f"[model] exposition: {len(prom.splitlines())} Prometheus lines, "
            f"{len(doc['metrics'])} JSON families ({doc['format']}), every required "
            f"family and phase present; cache hit rate "
            f"{reg16.gauge('odys_cache_hit_rate').value:.4f}")
    finally:
        set_registry(prev_reg)
    # python -m repro_torch.obs on the card (its default device)
    with tempfile.TemporaryDirectory() as tmp:
        for argv in (["demo", "--out", tmp], ["check", "--out", tmp], ["inert"]):
            rc = obs_main(argv)
            if rc != 0:
                raise AssertionError(f"python -m repro_torch.obs {' '.join(argv)}: rc {rc}")
    set_registry(prev_reg)
    log("[model] python -m repro_torch.obs demo / check / inert on the card: rc 0")
    phase_end("16 model")

    # ------------------------------------------------------------ 17. lm
    # The LM serving path at phi4-mini-3.8b's full width and depth, bf16,
    # random weights from the seed; K12 in every prefill's attention.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    lm_cfg = get_config("phi4-mini-3.8b")
    t0 = time.perf_counter()
    lm_params = lm.init_model(lm_cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_lm = lm.count_params(lm_params)
    if n_lm != lm_cfg.n_params_dense_equivalent() + (2 * lm_cfg.n_layers + 1) * lm_cfg.d_model:
        raise AssertionError(f"lm: {n_lm} parameters, not phi4-mini-3.8b's full width")
    log(f"[lm] {lm_cfg.name}: {lm_cfg.n_layers} layers (no depth cut), d {lm_cfg.d_model}, "
        f"H {lm_cfg.n_heads}, KV {lm_cfg.n_kv_heads}, hd {lm_cfg.hd}, d_ff {lm_cfg.d_ff}, "
        f"vocab {lm_cfg.vocab}, {lm_cfg.mlp}, {lm_cfg.norm}; {n_lm} parameters in "
        f"{lm_cfg.param_dtype} ({2 * n_lm} bytes), init {t_init:.2f} s from seed "
        f"{args.seed}; {held} bytes held by earlier phases")

    # K12 against the naive path on a float32 twin (only the compute
    # precision differs from the bf16 model); S = 1000 is no multiple of
    # K12's 128-row tiles
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(lm_cfg, param_dtype="float32", compute_dtype="float32")
    params32 = copy.deepcopy(lm_params).float()
    rng_lm = np.random.default_rng(args.seed)
    lm_tokens = torch.from_numpy(
        rng_lm.integers(0, lm_cfg.vocab, size=(2, 1000)).astype(np.int32)).to(dev)
    reset_launches()
    full32 = lm.forward_logits(params32, cfg32, {"tokens": lm_tokens})
    k12_f32 = launches_now()
    naive32 = lm.forward_logits(params32, dataclasses.replace(cfg32, attn_impl="naive"),
                                {"tokens": lm_tokens})
    if launches_now() != k12_f32 or k12_f32 != {**no_launch, "K12": lm_cfg.n_layers}:
        raise AssertionError(f"lm float32: launches {k12_f32} then {launches_now()}; "
                             f"expected K12 = {lm_cfg.n_layers} in the flash forward only")
    if full32.shape != (2, 1000, lm_cfg.vocab) or not bool(torch.isfinite(full32).all()):
        raise AssertionError(f"lm float32 logits {tuple(full32.shape)} or not finite")
    rr32, abs32 = fa.max_row_rel_err(full32, naive32), float((full32 - naive32).abs().max())
    log(f"[lm] float32 forward_logits (2, 1000): flash (K12 split TF32) vs naive: max abs "
        f"err {abs32:.4g}, row-relative {rr32:.4g} (bound 1e-3, every position)")
    if rr32 > 1e-3:
        raise AssertionError(f"lm: float32 flash vs naive row-relative {rr32} > 1e-3")
    del naive32

    # bfloat16: K12's last-position logits no further from float32 than the
    # naive bf16 path's, times 1.5
    last32 = full32[:, -1]
    bf_last = {impl: lm.forward_logits(lm_params, dataclasses.replace(lm_cfg, attn_impl=impl),
                                       {"tokens": lm_tokens})[:, -1].clone()
               for impl in ("flash", "naive")}
    rr_bf = {impl: fa.max_row_rel_err(x, last32) for impl, x in bf_last.items()}
    log(f"[lm] bfloat16 last-position logits vs float32 flash: K12 row-relative "
        f"{rr_bf['flash']:.4g}, naive bf16 {rr_bf['naive']:.4g} (bound 1.5x naive)")
    if not rr_bf["flash"] <= 1.5 * rr_bf["naive"]:
        raise AssertionError(f"lm: bf16 K12 error {rr_bf} beyond 1.5x the naive path's")

    # prefill + teacher-forced decode against the full forward (float32)
    last, lm_cache = lm.prefill(params32, cfg32, {"tokens": lm_tokens[:, :992]}, max_len=1000)
    tf_err = [fa.max_row_rel_err(last, full32[:, 991])]
    for t in range(992, 1000):
        step, lm_cache = lm.decode_step(params32, cfg32, lm_tokens[:, t:t + 1], lm_cache, t)
        tf_err.append(fa.max_row_rel_err(step, full32[:, t]))
    log(f"[lm] float32 prefill (992) + 8 decode steps vs forward_logits: row-relative "
        + ", ".join(f"{e:.3g}" for e in tf_err) + " (bound 1e-3)")
    if max(tf_err) > 1e-3:
        raise AssertionError(f"lm: prefill/decode vs forward row-relative {tf_err} > 1e-3")
    del params32, full32, last32, bf_last, lm_cache, last, step
    torch.cuda.empty_cache()

    # serve: 8 requests, batch 4, prompts of 128 to 1024 tokens
    prompts = [rng_lm.integers(0, lm_cfg.vocab, size=int(rng_lm.integers(128, 1025)))
               .astype(np.int32) for _ in range(8)]
    eng = lm_engine.ServingEngine(lm_cfg, batch_size=4, max_len=1040, device=dev,
                                  params=lm_params)
    serve_log = {"prefill": [], "decode": []}
    real_steps = {"prefill": lm_engine.prefill, "decode": lm_engine.decode_step}

    def timed(key):
        def run(*a, **kw):
            k0 = fa.flash_attention_fwd_cuda.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_steps[key](*a, **kw)
            torch.cuda.synchronize()
            serve_log[key].append((time.perf_counter() - t,
                                   fa.flash_attention_fwd_cuda.launches - k0))
            return out
        return run

    lm_engine.prefill, lm_engine.decode_step = timed("prefill"), timed("decode")
    try:
        for rid, prompt in enumerate(prompts):
            eng.submit(lm_engine.Request(rid=rid, prompt=prompt, max_new_tokens=16))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        served = []
        while eng.queue:
            served += eng.step_batch()
        t_serve = time.perf_counter() - t0
        serve_launches = launches_now()
        serve_peak = torch.cuda.max_memory_allocated()
        for rid, prompt in enumerate(prompts[:4]):
            eng.submit(lm_engine.Request(rid=100 + rid, prompt=prompt, max_new_tokens=16))
        again = eng.step_batch()
    finally:
        lm_engine.prefill, lm_engine.decode_step = real_steps["prefill"], real_steps["decode"]
    outs = {r.rid: r.output for r in served}
    if sorted(outs) != list(range(8)) or any(
            len(o) != 16 or not all(0 <= t < lm_cfg.vocab for t in o) for o in outs.values()):
        raise AssertionError(f"lm serve: outputs {outs}")
    if any(r.output != outs[r.rid - 100] for r in again):
        raise AssertionError("lm serve: the first batch served again gave other outputs")
    pre_log, dec_log = serve_log["prefill"][:2], serve_log["decode"][:30]
    if serve_launches != {**no_launch, "K12": 2 * lm_cfg.n_layers} or any(
            n != lm_cfg.n_layers for _, n in pre_log) or any(n for _, n in serve_log["decode"]):
        raise AssertionError(f"lm serve: launches {serve_launches}, per prefill "
                             f"{[n for _, n in pre_log]}, in decode "
                             f"{sum(n for _, n in serve_log['decode'])}")
    plens = [max(len(p) for p in prompts[i:i + 4]) for i in (0, 4)]
    dec_ms = [t * 1e3 for t, _ in dec_log]
    n_tok = sum(len(o) for o in outs.values())
    log(f"[lm] served 8 requests (prompts {[len(p) for p in prompts]}, batches padded to "
        f"{plens}) x 16 tokens: {n_tok} tokens in {t_serve:.3f} s, {n_tok / t_serve:.1f} "
        f"tok/s; prefill " + ", ".join(f"{t * 1e3:.2f}" for t, _ in pre_log)
        + f" ms a batch (K12 {[n for _, n in pre_log]}); decode {np.mean(dec_ms):.3f} ms "
        f"a token (batch of 4; min {min(dec_ms):.3f}, max {max(dec_ms):.3f}, 30 steps, "
        f"no K12); peak {serve_peak} bytes; launches {serve_launches['K12']} K12, nothing "
        f"else; the first batch again: equal outputs; on {smi}")
    del eng, again, served

    # the gemma-2b CLI on the card: full width, hd 256, MQA, tied head, GeGLU
    src_dir = str(Path(__file__).resolve().parent / "src")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b",
         "--requests", "8", "--batch", "4", "--new-tokens", "8", "--max-len", "512",
         "--seed", str(args.seed)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [src_dir, *filter(None, [os.environ.get("PYTHONPATH")])])))
    m = re.search(r"\[serve\] K12 launches (\d+)", cli.stdout)
    log("[lm] python -m repro_torch.launch.serve --arch gemma-2b --requests 8 --batch 4 "
        f"--new-tokens 8 --max-len 512: rc {cli.returncode}, "
        f"{time.perf_counter() - t0:.1f} s: " + " | ".join(cli.stdout.strip().splitlines()))
    if cli.returncode != 0 or not m or int(m.group(1)) != 2 * 18:
        raise AssertionError(f"lm: the gemma-2b CLI: rc {cli.returncode}, K12 "
                             f"{m and m.group(1)} (expected 36)\n{cli.stderr[-4000:]}")

    # K12 at the first served prefill's shape (B 4, S = T = its padded
    # length, H 24, KV 8, hd 128), as phase 14 times it
    s_ = plens[0]
    q, k, v = qkv(4, s_, s_, lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.hd, bf16)
    run = lambda: fa.flash_attention_fwd_cuda(q, k, v, q_chunk=s_, k_chunk=s_)  # noqa: E731
    plain = lambda: fa.flash_attention_fwd_torch(q, k, v, q_chunk=s_, k_chunk=s_)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    got, want = run().float(), plain().float()
    lm_err, lm_rr = float((got - want).abs().max()), fa.max_row_rel_err(got, want)
    if not torch.allclose(got, want, rtol=flash_tol[bf16], atol=flash_tol[bf16]) \
            or lm_rr >= fa.BF16_ROW_REL_TOL:
        raise AssertionError(f"lm: K12 at the served shape: max abs {lm_err}, "
                             f"row-relative {lm_rr}")
    del got, want
    lm_ms = cuda_ms(run, reps=20, warmup=3)
    lm_plain = cuda_ms(plain, reps=3, warmup=1)
    lm_lib = cuda_ms(sdpa, reps=20, warmup=3)
    n_bytes = 2 * (q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * 4 * lm_cfg.n_heads * s_ * s_ * lm_cfg.hd // 2
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    lm_bound, lm_by = max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
    log(f"[times] K12 at the first served prefill's shape (4, {s_}, {s_}, 24, 8, 128) causal "
        f"bfloat16: {lm_ms:.4f} ms/launch (CUDA events; x {lm_cfg.n_layers} layers "
        f"{lm_cfg.n_layers * lm_ms:.3f} ms of "
        f"the {pre_log[0][0] * 1e3:.2f} ms prefill); plain {lm_plain:.4f} ms; SDPA "
        f"(enable_gqa) {lm_lib:.4f} ms; bound {lm_bound:.4f} ms ({lm_by}); max abs err vs "
        f"plain {lm_err:.3g}, row-relative {lm_rr:.4f}; on {smi}")
    del q, k, v, qt, kt, vt, lm_params
    torch.cuda.empty_cache()
    phase_end("17 lm")

    # ------------------------------------------------------------ 18. lm-moe-hybrid
    lm18_records = lm_moe_hybrid(args, dev, smi, wrappers)
    phase_end("18 lm-moe-hybrid")

    k2_main = k2_rows[("tournament", 1000)]
    fill1 = mor[1.0]
    record = {"kernels": [
        {"name": "K1 driver_streamed_join", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/driver_streamed.cu",
         "replaces": "src/repro/kernels/posting_intersect.py:1207",
         "launches": static_launches["K1"], "max_abs_err": max_err["K1"],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "K2 topk_merge_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/topk_merge_rows.cu",
         "replaces": "src/repro/kernels/topk_merge.py:122",
         "launches": static_launches["K2"], "max_abs_err": max_err["K2"],
         "ms": k2_main[0], "plain_ms": k2_main[1], "bound_ms": k2_main[3],
         "bound_by": k2_main[4], "library_ms": k2_main[2]},
        {"name": "K3 merge_delta_windows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/delta_merge.cu",
         "replaces": "src/repro/kernels/delta_merge.py:394",
         "launches": fill1["K3"], "max_abs_err": max_err["K3"],
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib},
        {"name": "K4 intersect_batched_streamed", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/streamed_join.cu",
         "replaces": "src/repro/kernels/posting_intersect.py:958",
         "launches": fill1["K4"], "max_abs_err": max_err["K4"],
         "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": None},
        {"name": "K1p driver_streamed_join_packed", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/driver_streamed.cu",
         "replaces": "src/repro/kernels/posting_intersect.py:1207",
         "launches": p_static["K1p"], "max_abs_err": max_err["K1p"],
         "ms": k1p_ms, "plain_ms": k1p_plain, "bound_ms": k1p_bound,
         "bound_by": k1p_by, "library_ms": None},
        {"name": "K3p merge_delta_windows_packed", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/delta_merge.cu",
         "replaces": "src/repro/kernels/delta_merge.py:394",
         "launches": p_mor["K3p"], "max_abs_err": max_err["K3p"],
         "ms": k3p_ms, "plain_ms": k3p_plain, "bound_ms": k3p_bound,
         "bound_by": k3p_by, "library_ms": None},
        {"name": "K4p intersect_batched_streamed_packed", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/streamed_join.cu",
         "replaces": "src/repro/kernels/posting_intersect.py:958",
         "launches": p_mor["K4p"], "max_abs_err": max_err["K4p"],
         "ms": k4p_ms, "plain_ms": k4p_plain, "bound_ms": k4p_bound,
         "bound_by": k4p_by, "library_ms": None},
    ]}
    for kname, name, source, replaces, launches in (
        ("K6", "K6 driver_compact_join", "driver_compact.cu",
         "posting_intersect.py:1762", c_static["K6"]),
        ("K6p", "K6p driver_compact_join_packed", "driver_compact.cu",
         "posting_intersect.py:1762", c_static_p["K6p"]),
        ("K7", "K7 streamed_compact_join", "streamed_compact.cu",
         "posting_intersect.py:1500", c_mor["K7"]),
        ("K7p", "K7p streamed_compact_join_packed", "streamed_compact.cu",
         "posting_intersect.py:1500", c_mor_p["K7p"]),
        ("K8", "K8 merge_compact", "merge_compact.cu", "delta_merge.py:650",
         c_mor["K8"]),
        ("K8p", "K8p merge_compact_packed", "merge_compact.cu", "delta_merge.py:650",
         c_mor_p["K8p"]),
    ):
        ms, plain, bound, by, lib = compact_rows[kname]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": launches,
            "max_abs_err": max_err[kname], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib})
    for key, name, source, replaces, launches in (
        # launches of one 2**20 sort, from the profiler's device events
        ("K11 int32 n=2**20", "K11 bitonic_sort (2**20 keys)", "flat_sort.cu",
         "topk_merge.py:79", sum(k11_events.values())),
        ("K9 static", "K9 intersect_batched_block_skip", "staged_join.cu",
         "posting_intersect.py:533", st_counts["K9"]),
        ("K9 fill 1.0", "K9 intersect_batched_block_skip (fill 1.0, a_live)",
         "staged_join.cu", "posting_intersect.py:533", st_mor_counts["K9"]),
        ("K10 bench 4096 x 8192", "K10 intersect_block_skip", "staged_join.cu",
         "posting_intersect.py:396", ops_counts["K10"]),
        ("K11 int32 n=4096 (bench)", "K11 bitonic_sort", "flat_sort.cu",
         "topk_merge.py:79", ops_counts["K11"]),
        ("K4s", "K4s intersect_batched_streamed (static mode)", "streamed_join.cu",
         "posting_intersect.py:958", ops_counts["K4"]),
        ("K4ps", "K4ps intersect_batched_streamed_packed (static mode)",
         "streamed_join.cu", "posting_intersect.py:958", ops_counts["K4p"]),
        ("K7s", "K7s streamed_compact_join (static mode)", "streamed_compact.cu",
         "posting_intersect.py:1500", ops_counts["K7"]),
        ("K7ps", "K7ps streamed_compact_join_packed (static mode)",
         "streamed_compact.cu", "posting_intersect.py:1500", ops_counts["K7p"]),
    ):
        ms, plain, bound, by, lib = staged_rows[key]
        err_key = key.split()[0]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": launches,
            "max_abs_err": max_err[err_key], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib})
    for (config, dtype), (ms, plain, bound, by, lib) in flash_rows.items():
        record["kernels"].append({
            "name": f"K12 flash_attention_fwd ({config}, causal, {str(dtype)[6:]})",
            "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:136",
            "launches": flash_launches["K12"], "max_abs_err": flash_err[dtype], "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib})
    record["kernels"].append({
        "name": "K12 flash_attention_fwd (phi4-mini serving prefill, causal, bfloat16)",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:136",
        "launches": serve_launches["K12"], "max_abs_err": lm_err, "ms": lm_ms,
        "plain_ms": lm_plain, "bound_ms": lm_bound, "bound_by": lm_by, "library_ms": lm_lib})
    record["kernels"].extend(lm18_records)
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
