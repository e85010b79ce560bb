"""Launch drivers: elastic re-sharding and set failover (the search side of
``repro.launch``) and the LM serving CLI (``python -m repro_torch.launch.serve``)."""
