"""``pad_share``: inert padding clones over the query slots the window's
batches dispatched (%), from the scheduler's counters
(``SearchService.stats()``: ``n_padded``, ``n_batches`` x batch size)."""


def read(run):
    batches = run.stats_after["n_batches"] - run.stats_before["n_batches"]
    if batches <= 0:
        return None
    padded = run.stats_after["n_padded"] - run.stats_before["n_padded"]
    return 100.0 * padded / (batches * run.batch_size)
