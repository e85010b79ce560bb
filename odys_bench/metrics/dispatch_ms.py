"""``dispatch_ms``: the port's ``slave_dispatch`` phase (host batch build
and every launch of the slave join and the master merge,
``serving/search.py:_execute`` around ``_run_engine``) per batch, over the
batches of the traced run's phase segment: the loop run on for the
traffic's ``trace_phase_s`` after the window, with the port's registry
live, before the profiled segment."""


def read(run):
    got = [p["slave_dispatch"] for p in run.phases if "slave_dispatch" in p]
    return 1e3 * sum(got) / len(got) if got else None
