"""``batch_build_ms``: the port's ``batch_build`` phase (``odys.batch_build``
in ``core/engine.py:make_query_batch``: the host arrays of a batch and
their host-to-device copies) per batch, over the batches of the traced
run's phase segment (see ``dispatch_ms``).  It lies inside
``dispatch_ms``."""


def read(run):
    got = [p["batch_build"] for p in run.phases if "batch_build" in p]
    return 1e3 * sum(got) / len(got) if got else None
