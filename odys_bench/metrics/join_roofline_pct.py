"""``join_roofline_pct``: the slave join's least time over the profiled
batches (``odys_bench/work.py``: its bytes at 3.35 TB/s, its int32
operations at 67 T/s, one H100 SXM at 700 W) over the device time the
profiler gives the join's kernels (%).

The join's kernels, by the ``__global__`` names of the port's sources: K1
(``csrc/driver_streamed.cu``) on the static index; K3
(``csrc/delta_merge.cu``) and K4 (``csrc/streamed_join.cu``) under
merge-on-read.  A run that launches none of them reads nothing."""

JOIN_KERNELS = {
    False: ("driver_streamed_kernel",),
    True: ("delta_merge_kernel", "streamed_join_kernel"),
}


def read(run):
    if run.device is None or run.join_least_s is None:
        return None
    seconds = run.device.seconds_of(JOIN_KERNELS[run.merge_on_read])
    if seconds <= 0:
        return None
    return 100.0 * run.join_least_s / seconds
