"""The closed loop: ``clients`` searchers, each with one query outstanding.

A turn applies and publishes the due bulk of mutations (ingest traffic),
runs one batch through the scheduler's ``step()``, and gives each searcher
whose answer came back its next query from the stream.  Arrivals follow
answers, so the service runs at the rate it sustains.
"""

#: The traffic keys this loop reads.
KEYS = {"clients"}


def run(s, stop) -> None:
    """Drive session ``s`` until ``stop()`` is true (checked every turn)."""
    clients = int(s.traffic["clients"])
    while s.outstanding < clients:
        s.submit_next()
    while not stop():
        s.publish_if_due()
        done = s.step()
        with s.span("bench.admit"):
            s.collect(done)
            for _ in done:
                s.submit_next()
