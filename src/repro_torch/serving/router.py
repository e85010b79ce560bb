"""Serving-layer routing: set-health-aware batch routing (port of
``repro.serving.router``'s :class:`HealthAwareRouter`).

**Batch routing** (paper §3.1/§5.2): :class:`HealthAwareRouter` extends the
scheduler's least-loaded multi-set router with the set-granular failover of
:mod:`repro_torch.core.faults` — a dead ODYS set receives no batches
(queries are stateless and the index replicated, so skipping a set is safe)
and resumes receiving them the moment it recovers.  Wire it into
:class:`~repro_torch.serving.scheduler.MasterScheduler` via ``router=``
(the :class:`~repro_torch.serving.search.SearchService` ``set_health=``
knob does so).  On one card the sets time-share the device; the router
only decides which set's accounting a batch joins.

**Greedy decoding**: :func:`greedy_token` is the LM serving engine's
argmax over the vocabulary.  The JAX package distributes it over a
vocab-sharded mesh (``distributed_vocab_topk``); on one card there is no
mesh, and that path is out of this round.
"""
from __future__ import annotations

import torch

from repro_torch.core.faults import SetHealth
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


def greedy_token(logits: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """argmax next token (B,) int32 over the last axis; the first maximum
    on a tie, as ``jnp.argmax``.  A ``mesh`` is refused: the port serves on
    one card."""
    if mesh is not None:
        raise NotImplementedError("greedy_token: no mesh on one card (the "
                                  "distributed vocab top-k is out of this round)")
    return torch.argmax(logits, dim=-1).to(torch.int32)
