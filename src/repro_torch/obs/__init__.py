"""Metrics registry and per-query phase spans (copies of ``repro.obs``)."""
