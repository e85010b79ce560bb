"""Serving-layer routing: set-health-aware batch routing (port of
``repro.serving.router``'s :class:`HealthAwareRouter`).

**Batch routing** (paper §3.1/§5.2): :class:`HealthAwareRouter` extends the
scheduler's least-loaded multi-set router with the set-granular failover of
:mod:`repro_torch.core.faults` — a dead ODYS set receives no batches
(queries are stateless and the index replicated, so skipping a set is safe)
and resumes receiving them the moment it recovers.  Wire it into
:class:`~repro_torch.serving.scheduler.MasterScheduler` via ``router=``
(the :class:`~repro_torch.serving.search.SearchService` ``set_health=``
knob does so).  With ``set_meshes`` each set is its own ranks; without,
the sets time-share the service's device and the router only decides
which set's accounting a batch joins.

**LM head top-k**: greedy or top-k decoding with the LM head sharded over
the ``model`` axis is the ODYS master/slave merge problem: each rank owns
a vocabulary slice (its "document partition"), takes its local top-k
(the slave top-k), and a log-depth tournament merges candidates (the
master's loser tree), so k candidates a rank move instead of the whole
(B, V) logits.  :func:`distributed_vocab_topk` runs it over a
:class:`~torch.distributed.device_mesh.DeviceMesh`, one process a rank.
A tie between values keeps the lower token id, on every rank (ROADMAP
R11), which is the copy the reference hands back.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.faults import SetHealth
from repro_torch.core.parallel import exchange, gather
from repro_torch.serving.scheduler import MultiSetRouter, SetState


class HealthAwareRouter(MultiSetRouter):
    """Multi-set router that honors :class:`~repro_torch.core.faults.SetHealth`.

    Routing skips dead sets; :meth:`fail` / :meth:`recover` flip a set's
    health (or mutate the shared ``SetHealth`` directly — e.g. the fault
    simulator's own mask can be passed in).  With every set dead, routing
    raises ``RuntimeError`` exactly like
    :func:`repro_torch.core.faults.route_queries`.
    """

    def __init__(self, n_sets: int, health: SetHealth | None = None):
        super().__init__(n_sets)
        self.health = health if health is not None else SetHealth.all_alive(n_sets)
        if self.health.n_sets != n_sets:
            # an undersized mask would IndexError (or silently misroute)
            # only at route time — fail at construction instead
            raise ValueError(
                f"health mask covers {self.health.n_sets} sets, "
                f"router has {n_sets}"
            )
        self.health.subscribe(self._on_health_change)
        # base __init__ bound the process registry before self.health
        # existed — rebind now so the health instruments come up too
        self.bind_registry(self._registry)

    def bind_registry(self, reg) -> None:
        super().bind_registry(reg)
        self._registry = reg
        self._c_transitions = {
            to: reg.counter(
                "odys_set_health_transitions_total",
                help="set liveness transitions observed by the router",
                to=to,
            )
            for to in ("alive", "dead")
        }
        health = getattr(self, "health", None)
        self._g_alive = {
            s.sid: reg.gauge(
                "odys_set_alive",
                help="1 while the set is routable, 0 while dead",
                set=str(s.sid),
            )
            for s in self.sets
        }
        if health is not None:
            for s in self.sets:
                self._g_alive[s.sid].set(float(bool(health.alive[s.sid])))

    def _on_health_change(self, set_id: int, alive: bool) -> None:
        self._c_transitions["alive" if alive else "dead"].inc()
        g = self._g_alive.get(set_id)
        if g is not None:
            g.set(1.0 if alive else 0.0)

    def _candidates(self) -> list[SetState]:
        alive = [s for s in self.sets if bool(self.health.alive[s.sid])]
        if not alive:
            raise RuntimeError("no ODYS set alive")
        return alive

    def fail(self, set_id: int) -> None:
        self.health.fail(set_id)

    def recover(self, set_id: int) -> None:
        self.health.recover(set_id)


def _top_k(values: torch.Tensor, k: int):
    """Descending top-k along the last axis that keeps the earlier position
    on a tie, as ``lax.top_k`` (``torch.topk`` does not promise an order
    among equal values)."""
    v, sel = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], sel[..., :k]


def _merge_scored(av, ai, bv, bi, k: int):
    """Merge two descending (B, k) scored candidate sets -> the best k; on
    a tie the first set's candidate wins."""
    v, sel = _top_k(torch.cat([av, bv], dim=-1), k)
    return v, torch.gather(torch.cat([ai, bi], dim=-1), -1, sel)


def tournament_topk_scored(values, indices, mesh: DeviceMesh, axis: str, n: int,
                           k: int):
    """Butterfly merge of this rank's (B, k) candidates over ``axis`` (n a
    power of two).  In each round the partner with the lower coordinate
    holds the lower token ids and goes first, so on a tie every rank keeps
    the lower id and all ranks end equal."""
    if n & (n - 1):
        raise ValueError(f"tournament top-k needs a power-of-two axis, got {n}")
    group, i = mesh.get_group(axis), mesh.get_local_rank(axis)
    d = 1
    while d < n:
        ov = exchange(values, group, i ^ d)
        oi = exchange(indices, group, i ^ d)
        if i & d:
            values, indices = _merge_scored(ov, oi, values, indices, k)
        else:
            values, indices = _merge_scored(values, indices, ov, oi, k)
        d *= 2
    return values, indices


def distributed_vocab_topk(
    local_logits: torch.Tensor,
    *,
    mesh: DeviceMesh,
    k: int = 1,
    axis: str = "model",
    strategy: str = "tournament",
    batch_axes=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-k ``(values, token_ids)`` of vocab-sharded logits.

    Every rank of ``axis`` calls it with its slice ``local_logits`` (B,
    V/n), slice ``i`` holding token ids ``[i*V/n, (i+1)*V/n)``, and gets the
    (B, k) result: values descending, ids int32, the lower id first on a
    tie.  ``strategy`` is ``"tournament"`` (log2(n) exchanges of k
    candidates) or ``"allgather"`` (every rank's k, one top-k).
    ``batch_axes`` names mesh axes the batch is split over (each rank
    passes its rows); no collective crosses them."""
    del batch_axes  # the rows a rank holds are its own; only ``axis`` merges
    if strategy not in ("tournament", "allgather"):
        raise ValueError(f"unknown strategy {strategy!r}")
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    shard = mesh.get_local_rank(axis)
    lv, li = _top_k(local_logits, k)                  # the slave side
    gi = (li + shard * local_logits.shape[-1]).to(torch.int32)  # global ids
    if strategy == "tournament":
        return tournament_topk_scored(lv, gi, mesh, axis, n, k)
    group = mesh.get_group(axis)
    allv = torch.cat(gather(lv, group), dim=-1)      # (B, n*k), rank order
    alli = torch.cat(gather(gi, group), dim=-1)
    v, sel = _top_k(allv, k)
    return v, torch.gather(alli, -1, sel)


def greedy_token(logits: torch.Tensor, *, mesh: DeviceMesh | None = None,
                 axis: str = "model") -> torch.Tensor:
    """argmax next token (B,) int32 over the last axis; the first maximum
    on a tie, as ``jnp.argmax``.  With a ``mesh`` that has ``axis``,
    ``logits`` is this rank's vocabulary slice and the token comes from
    :func:`distributed_vocab_topk` (k = 1), the same on every rank."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    _, idx = distributed_vocab_topk(logits, mesh=mesh, k=1, axis=axis)
    return idx[..., 0].to(torch.int32)
