"""``admit_us``: one query's admission (the port's ``admit`` phase: the
whole ``MasterScheduler.submit`` call, bucket, ticket, span and cache
probe), over the first query of each batch of the traced run's phase
segment (see ``dispatch_ms``)."""


def read(run):
    got = [p["admit"] for p in run.phases if "admit" in p]
    return 1e6 * sum(got) / len(got) if got else None
