"""Launch drivers: elastic re-sharding and set failover (the search side of
``repro.launch``), the LM serving CLI (``python -m repro_torch.launch.serve``)
and the LM training CLI (``python -m repro_torch.launch.train``)."""
