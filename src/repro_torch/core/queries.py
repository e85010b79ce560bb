"""Query workload generation (paper §5.1), as in ``repro.core.queries``.

Three search-condition types and three top-k values (Fig 7(c)) over the
synthetic corpus: keywords drawn Zipf-like, siteIds uniform, exponential
inter-arrival gaps.  The same numpy draws in the same order as the
reference, so the same config gives the same queries.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import QueryBatch, make_query_batch
from repro_torch.core.index import IndexMeta
from repro_torch.core.perfmodel import QueryMix


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    sct: str                 # "single" | "multiple" | "limited"
    k: int                   # 10 | 50 | 1000
    terms: tuple[int, ...]
    site: int | None
    arrival: float           # seconds since stream start


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_queries: int = 1000
    arrival_rate: float = 100.0       # queries/sec (Poisson)
    zipf_s: float = 1.1
    max_terms: int = 3
    seed: int = 0


def generate_workload(
    meta: IndexMeta, mix: QueryMix, cfg: WorkloadConfig
) -> list[QuerySpec]:
    rng = np.random.default_rng(cfg.seed)
    kinds = list(mix.qmr.keys())
    probs = np.array([mix.qmr[kk] for kk in kinds])
    choices = rng.choice(len(kinds), size=cfg.n_queries, p=probs)

    ranks = np.arange(1, meta.vocab_size + 1, dtype=np.float64)
    term_p = ranks ** (-cfg.zipf_s)
    term_p /= term_p.sum()

    gaps = rng.exponential(1.0 / cfg.arrival_rate, size=cfg.n_queries)
    arrivals = np.cumsum(gaps)

    out: list[QuerySpec] = []
    for i, ci in enumerate(choices):
        sct, k = kinds[ci]
        if sct == "single":
            nt = 1
        else:
            nt = int(rng.integers(2, cfg.max_terms + 1))
        terms = tuple(
            int(t) for t in rng.choice(meta.vocab_size, size=nt, replace=False,
                                       p=term_p)
        )
        site = int(rng.integers(0, meta.n_sites)) if sct == "limited" else None
        out.append(QuerySpec(sct, k, terms, site, float(arrivals[i])))
    return out


def batch_by_k(
    specs: list[QuerySpec],
    *,
    t_max: int = 4,
    meta: IndexMeta | None = None,
    strategy: str = "embed",
    device=None,
) -> dict[int, tuple[QueryBatch, list[QuerySpec]]]:
    """Group a workload into fixed-k QueryBatches on ``device``."""
    groups: dict[int, list[QuerySpec]] = {}
    for s in specs:
        groups.setdefault(s.k, []).append(s)
    out = {}
    for k, ss in groups.items():
        qb = make_query_batch(
            [(list(s.terms), s.site) for s in ss],
            t_max=t_max, meta=meta, strategy=strategy, device=device,
        )
        out[k] = (qb, ss)
    return out
