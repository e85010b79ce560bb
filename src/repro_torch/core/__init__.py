"""Index, slave engine, distributed query path, workload, performance model."""
