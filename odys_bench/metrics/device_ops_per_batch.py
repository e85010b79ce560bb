"""``device_ops_per_batch``: kernels, memcpys and memsets in the profiled
window over the batches it holds (``torch.profiler``)."""


def read(run):
    if run.device is None or not run.traced_batches:
        return None
    return len(run.device.ops) / len(run.traced_batches)
