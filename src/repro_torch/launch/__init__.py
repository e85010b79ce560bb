"""Elastic re-sharding and set failover (the search side of ``repro.launch``)."""
