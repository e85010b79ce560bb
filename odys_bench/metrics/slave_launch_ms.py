"""``slave_launch_ms``: the port's ``slave_launch`` phase (``odys.slave``,
one a slave in ``core/parallel.py:slave_topk_unmerged``: the plan, the
join's launch, the first-k sort and the docIDs made global), summed over
the slaves, per batch, over the batches of the traced run's phase segment
(see ``dispatch_ms``).  It lies inside ``dispatch_ms``."""


def read(run):
    got = [p["slave_launch"] for p in run.phases if "slave_launch" in p]
    return 1e3 * sum(got) / len(got) if got else None
