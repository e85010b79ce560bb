"""``finalize_ms``: the port's ``finalize`` phase (host extraction of the
hits, ``serving/search.py:_execute``) per batch, over the batches of the
traced run's phase segment (see ``dispatch_ms``)."""


def read(run):
    got = [p["finalize"] for p in run.phases if "finalize" in p]
    return 1e3 * sum(got) / len(got) if got else None
