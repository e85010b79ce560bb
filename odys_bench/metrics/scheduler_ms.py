"""``scheduler_ms``: the scheduler's own host work a batch, the port's
``form`` phase (batch formation, padding, the route, the dispatch-time
cache recheck, ``odys.form``) plus its ``complete`` phase (the ticket loop,
cache puts and counters after the executor returns, ``odys.complete``),
over the batches of the traced run's phase segment (see ``dispatch_ms``)."""


def read(run):
    got = [p["form"] + p["complete"] for p in run.phases
           if "form" in p and "complete" in p]
    return 1e3 * sum(got) / len(got) if got else None
