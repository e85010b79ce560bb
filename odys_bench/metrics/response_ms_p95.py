"""``response_ms_p95``: the 95th percentile, over every query answered in
the window, of its ticket's ``finish_time - submit_time`` on the host's
clock (ms).  The traced run's window runs as an untraced run's does: the
port's registry and the profiler come on only after it closes.

A per-layer reading: in a saturated closed loop the tail follows the
cycles in which the scheduler's ``(t_max, k)`` buckets fill, so it swings
from run to run while the rate holds."""

import numpy as np


def read(run):
    if not run.response_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(run.response_s), 95))
