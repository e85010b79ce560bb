"""Closed-loop calibration of the hybrid perf model from the live engine
(port of ``repro.core.calibrate``).

The paper's hybrid model (§4) is analytic for the master and network and
*experimental* for the slaves; §5.1 fits the analytic constants (Table 3)
by measuring the real system.  :mod:`repro_torch.core.perfmodel` ships
Table 3 verbatim, but those numbers describe a 2012 Odysseus cluster, not
this engine.  This module is the measurement half for the port, on the
index's device:

- :func:`measure_service_times` times the slave phase
  (:func:`~repro_torch.core.parallel.slave_topk_unmerged`) against the
  full master path (query-batch construction,
  :func:`~repro_torch.core.parallel.distributed_query_topk` and the host
  result extraction) on the same batch; the difference is the measured
  per-query master service time (Formula (4)'s ``ST_master``), and the
  per-repetition slave timings feed the paper's partitioning method (§4.2,
  Fig 9) for the expected slave max.
- :func:`fit_merge_constants` measures the master's top-k merge at several
  merge widths and least-squares Formula (7)
  ``T_merge = k * (ceil(log2 ns) * t_comparison + t_base)`` for the two
  loser-tree constants.
- :func:`calibrate_from_engine` assembles a fitted
  :class:`~repro_torch.core.perfmodel.MasterParams`: the merge constants
  from the fit, the fixed/per-slave split of the residual master overhead
  by an attribution ratio (documented below), context-switch cost zero (the
  in-process engine has no RPC thread switches), and unmeasured top-k rows
  extrapolated with the paper's Table 3 ratios.

**Timing waits for the device.**  Kernel launches return when they are
queued, so :func:`_timed` synchronises the device before it reads the
clock and after every call: a time is what a query pays, host work and
device work together, on the wall clock.  The first call of each timed
function runs outside the timed repetitions (it builds the kernels and
warms the caching allocator).  With ``backend="kernel"`` on a CUDA index
the slaves run K1 and the merges K2; on a CPU index their plain versions.

**One card, ns shards in turn.**  The ns slaves run one after another
(the loop in :func:`~repro_torch.core.parallel.slave_topk_unmerged`), so
``st_slave`` is the *sum* of the ns shards' times, as it is on the JAX
package's one-host mesh; the per-shard samples the partitioning method
gets are that sum, repeated ns times (the reference's definition).

The arithmetic (Formulas (4) and (7), :data:`_PARENT_FRACTION`,
:data:`_FLOOR`) is the JAX package's, so the same timings give the same
fitted parameters to the last bit.
"""
from __future__ import annotations

import dataclasses
import math
import time
from functools import partial

import numpy as np
import torch

from repro_torch.core.engine import make_query_batch
from repro_torch.core.index import INVALID_DOC, resolve_device
from repro_torch.core.parallel import (
    _row_topk,
    distributed_query_topk,
    slave_topk_unmerged,
)
from repro_torch.core.perfmodel import (
    KS,
    SINGLE_10_ONLY,
    MasterParams,
    NetworkParams,
    OdysPerfModel,
    PAPER_TABLE3_MASTER,
    engine_cluster,
    sojourn,
)
from repro_torch.core.slave_max import partitioning_method

# Attribution of the k=10 master overhead between the fixed per-query part
# (T_parent_proc) and the per-slave part ((T_child_proc+rpc)*ns): a single
# measured ns cannot separate them, so we follow the paper's own Table 3
# proportions, where the parent's fixed cost dominates at small ns.
_PARENT_FRACTION = 0.8

_FLOOR = 1e-8  # seconds; keeps fitted params positive and queues stable


def _sync(device: torch.device | None) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, *args, reps: int = 3, device: torch.device | None = None,
           **kw) -> list[float]:
    """Per-repetition wall times (seconds) after one warm-up call; on a
    CUDA ``device`` each repetition ends in a device synchronise, and the
    clock starts after one."""
    fn(*args, **kw)
    _sync(device)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync(device)
        out.append(time.perf_counter() - t0)
    return out


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Fitted model parameters + the raw measurements behind them."""

    master: MasterParams
    network: NetworkParams
    ns: int
    st_slave: dict        # per-k measured slave service time / query (s)
    st_master: dict       # per-k measured master service time / query (s)
    slave_max: dict       # per-k partitioning-method E[slave max] (s)
    t_comparison: float
    t_base: float
    n_sets: int = 1       # replicated sets the arrival stream spreads over

    def with_sets(self, n_sets: int) -> "Calibration":
        """Same fitted parameters projected at ``n_sets`` replicated sets:
        Formula (17) spreads the arrival stream as ``lam / n_sets`` (§5.2)."""
        return dataclasses.replace(self, n_sets=int(n_sets))

    def slave_max_time(self, sct: str, k: int, lam: float, ns: int) -> float:
        """The hybrid's experimental half for Formula (17), load-aware.

        The engine runs one batch at a time, so the slave tier is a single
        deterministic server at the measured per-query service time: its
        sojourn under the set's arrival rate is the M/D/1 Formula (13), and
        the measured partitioning-method max inflates it by the
        calibration-time max/mean ratio (§4.2's disk-variance spread, here
        the shard-lockstep spread).  Unmeasured k falls back to the nearest
        measured k.
        """
        del sct, ns
        kk = k if k in self.slave_max else min(
            self.slave_max, key=lambda m: abs(m - k)
        )
        st = self.st_slave[kk]
        inflation = self.slave_max[kk] / max(st, _FLOOR)
        return sojourn(lam / self.n_sets, st) * inflation

    def max_stable_load(self, mix=SINGLE_10_ONLY) -> float:
        """Largest arrival rate at which every queue of the fitted model
        stays stable: the analytic master and network queues
        (:meth:`OdysPerfModel.max_stable_load`, which leaves the slaves
        out) and the measured slave tier of :meth:`slave_max_time`, whose
        M/D/1 sojourn diverges at ``lam = n_sets / st_slave``.  (Not in the
        JAX package: its callers take the minimum by hand.)"""
        model = OdysPerfModel(master=self.master, network=self.network)
        analytic = model.max_stable_load(
            engine_cluster(self.ns, n_sets=self.n_sets), mix)
        slowest = max(
            self.st_slave[min(self.st_slave, key=lambda m: abs(m - k))]
            for (_, k), ratio in mix.qmr.items() if ratio > 0.0
        )
        return min(analytic, self.n_sets / max(slowest, _FLOOR))

    def projected_response(
        self,
        lam: float,
        *,
        batch_size: int = 1,
        max_wait: float = 0.0,
        mix=SINGLE_10_ONLY,
    ) -> float:
        """Formula (17) projection at arrival rate ``lam``, plus the
        micro-batcher's expected formation delay.

        The one code path both validation surfaces use: an offline replay
        reports it against its measurements, and the online
        :class:`~repro_torch.obs.residual.ModelResidualMonitor` compares it
        against live spans — so the two Formula (18) errors agree by
        construction.

        The formation term is the mean residual wait of a Poisson arrival
        in a size-``batch_size`` batch former, capped by the formation
        deadline: ``min(max_wait, (batch_size - 1) / (2 lam))``.
        """
        model = OdysPerfModel(master=self.master, network=self.network)
        cluster = engine_cluster(self.ns, n_sets=self.n_sets)
        base = model.total_response_time(lam, cluster, mix, self.slave_max_time)
        formation = (
            min(max_wait, (batch_size - 1) / (2.0 * lam))
            if batch_size > 1 else 0.0
        )
        return base + formation


def calibration_from_fields(*, master: dict, network: dict, **fields) -> Calibration:
    """A :class:`Calibration` from plain fields, as
    ``dataclasses.asdict`` of either package's calibration gives them."""
    return Calibration(master=MasterParams(**master),
                       network=NetworkParams(**network), **fields)


def fit_merge_constants(
    *,
    k_values=(10, 50),
    widths=(2, 4, 8),
    q: int = 8,
    reps: int = 3,
    backend: str = "kernel",
    device=None,
    seed: int = 0,
) -> tuple[float, float, dict]:
    """Fit Formula (7)'s (t_comparison, t_base) from measured merges.

    Times the master's per-row best-k reduction (the same ``_row_topk``
    the tournament/allgather merges run: K2 under ``backend="kernel"`` on a
    CUDA ``device``) over ``widths`` candidate sets of ``w * k`` each, then
    least-squares the loser-tree cost model
    ``T = k * (ceil(log2 w) * t_cmp + t_base)`` per query.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows_x, rows_y, raw = [], [], {}
    for k in k_values:
        for w in widths:
            cands = torch.from_numpy(
                np.sort(rng.integers(0, 2**30, size=(q, w * k)))
                .astype(np.int32)
            ).to(dev)
            merge = partial(_row_topk, k=k, backend=backend)
            per_q = min(_timed(merge, cands, reps=reps, device=dev)) / q
            raw[(k, w)] = per_q
            rows_x.append([k * math.ceil(math.log2(w)), k])
            rows_y.append(per_q)
    sol, *_ = np.linalg.lstsq(
        np.asarray(rows_x, dtype=np.float64),
        np.asarray(rows_y, dtype=np.float64),
        rcond=None,
    )
    t_cmp = max(float(sol[0]), _FLOOR)
    t_base = max(float(sol[1]), _FLOOR)
    return t_cmp, t_base, raw


def measure_service_times(
    index,
    meta,
    *,
    ns: int,
    k: int,
    window: int = 1024,
    t_max: int = 2,
    q: int = 8,
    reps: int = 4,
    backend: str = "kernel",
    merge: str = "tournament",
    seed: int = 0,
) -> tuple[float, float, np.ndarray]:
    """Measure (st_slave, st_master, slave_samples) per query at top-``k``
    on the index's device.

    ``st_slave`` is the slave-phase service time (no merge; on one card
    the ns shards in turn); ``st_master`` is the **full master path** —
    query-batch construction, dispatch, the distributed merge, and
    host-side result extraction, i.e. everything the serving executor does
    per batch — minus the slave phase: the live analogue of Formula (4),
    where the paper's ``T_parent_proc`` is likewise the master's own
    per-query processing.  ``slave_samples`` is the per-repetition
    slave-time series, repetition-major, ready for the partitioning method
    (§4.2 Step 1.2 builds exactly this sequence).
    """
    dev = index.postings.device
    rng = np.random.default_rng(seed)
    vocab_head = max(2, min(64, meta.vocab_size))
    queries = [([int(t)], None)
               for t in rng.integers(0, vocab_head, size=q)]
    qb = make_query_batch(queries, t_max=t_max, meta=meta, device=dev)
    common = dict(ns=ns, k=k, window=window, backend=backend)

    def master_path(qs):
        """What the serving executor runs per batch (search.py)."""
        batch = make_query_batch(qs, t_max=t_max, meta=meta, device=dev)
        res = distributed_query_topk(index, batch, merge=merge, **common)
        docs = res.docids.cpu().numpy()
        hits = res.n_hits.cpu().numpy()
        return [
            ([int(d) for d in row if d != INVALID_DOC], int(h))
            for row, h in zip(docs, hits)
        ]

    slave_times = _timed(slave_topk_unmerged, index, qb, reps=reps,
                         device=dev, **common)
    e2e_times = _timed(master_path, queries, reps=reps, device=dev)
    st_slave = min(slave_times) / q
    st_master = max(min(e2e_times) / q - st_slave, _FLOOR)
    # One slave-max sample per repetition x shard: the shards' slave-phase
    # time, measured as one (on one card, their sum), repeated for each.
    samples = np.repeat(np.asarray(slave_times) / q, ns)[None, :]
    return st_slave, st_master, samples


def calibrate_from_engine(
    index,
    meta,
    *,
    ns: int,
    k_values=(10, 50),
    window: int = 1024,
    t_max: int = 2,
    q: int = 8,
    reps: int = 4,
    backend: str = "kernel",
    merge: str = "tournament",
    n_sets: int = 1,
    seed: int = 0,
) -> Calibration:
    """Fit a :class:`MasterParams` from live-engine measurements on the
    index's device.

    ``k_values`` must include 10 (the unit query every weight in
    §4.1.3 is normalized against).  Top-k rows the caller does not measure
    (e.g. k=1000 on a small corpus) are extrapolated with the paper's
    Table 3 ratios and marked by their absence from ``st_master``.
    """
    if 10 not in k_values:
        raise ValueError("the unit query (k=10) must be measured")
    t_cmp, t_base, _ = fit_merge_constants(
        k_values=k_values, q=q, reps=reps, backend=backend,
        device=index.postings.device, seed=seed,
    )
    st_slave, st_master, slave_max = {}, {}, {}
    for k in k_values:
        s, m, samples = measure_service_times(
            index, meta, ns=ns, k=k, window=window, t_max=t_max,
            q=q, reps=max(reps, ns), backend=backend,
            merge=merge, seed=seed + k,
        )
        st_slave[k] = s
        st_master[k] = m
        slave_max[k] = float(partitioning_method(samples, ns).mean())

    # Formula (4) decomposition at the measured ns: subtract the fitted
    # merge cost, then split the residual overhead into the fixed parent
    # part and the per-slave RPC part by the attribution ratio.
    log_ns = math.ceil(math.log2(ns)) if ns > 1 else 0
    residual = {
        k: max(st_master[k] - k * (log_ns * t_cmp + t_base), _FLOOR)
        for k in k_values
    }
    t_parent = max(_PARENT_FRACTION * residual[10], _FLOOR)
    rpc = {
        k: max((residual[k] - t_parent) / ns, _FLOOR) for k in k_values
    }
    paper_rpc = PAPER_TABLE3_MASTER.T_master_rpc
    for k in KS:
        if k not in rpc:  # extrapolate with the paper's Table 3 ratio
            rpc[k] = rpc[10] * paper_rpc[k] / paper_rpc[10]
    master = MasterParams(
        T_parent_proc=t_parent,
        T_child_proc=0.0,
        T_master_rpc=dict(rpc),
        t_comparison=t_cmp,
        t_base=t_base,
        # No RPC thread context switches in-process: the term is inert,
        # but the ncs tables keep Table 3's structure for reporting.
        t_per_context_switch=0.0,
        ncs_base=dict(PAPER_TABLE3_MASTER.ncs_base),
        ncs_per_slave=dict(PAPER_TABLE3_MASTER.ncs_per_slave),
        alpha=PAPER_TABLE3_MASTER.alpha,
    )
    # In-process "network": a shared-memory hop.  Equal epsilon rows keep
    # every w_network weight at 1 and the network queue at ~zero load.
    network = NetworkParams(ST_network={k: 1e-9 for k in KS})
    return Calibration(
        master=master, network=network, ns=ns,
        st_slave=st_slave, st_master=st_master, slave_max=slave_max,
        t_comparison=t_cmp, t_base=t_base, n_sets=n_sets,
    )
