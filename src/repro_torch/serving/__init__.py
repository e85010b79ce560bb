"""Serving layer: the ODYS master pipeline on one card.

:mod:`repro_torch.serving.search`'s `SearchService` binds the admission
pipeline (:mod:`repro_torch.serving.scheduler`: ``(t_max, k)``-bucketed
micro-batches, the version-stamped LRU result cache, the multi-set router)
to the distributed query engine.  With ``set_health=`` the router is the
health-aware one of :mod:`repro_torch.serving.router`: a dead ODYS set is
skipped and re-admitted on recovery.  The ``n_sets`` sets time-share the
card.  :mod:`repro_torch.core.calibrate` fits the paper's hybrid
performance model from this pipeline, and
:class:`~repro_torch.obs.residual.ModelResidualMonitor` exports the live
Formula (18) error against it.

:class:`~repro_torch.serving.engine.ServingEngine` is the LM substrate's
batched serving engine (prefill, then greedy decode) on the same batch
formation.
"""
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.router import HealthAwareRouter, greedy_token  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    MasterScheduler,
    MultiSetRouter,
    QueryTicket,
    ResultCache,
    form_batch,
)
from repro_torch.serving.search import SearchHit, SearchService  # noqa: F401
