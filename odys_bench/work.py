"""The slave join's least work, and the card's peaks it is held against.

The count follows the pattern of the port's launch contracts and roofline
(``kernels/registry.py``, ``roofline/``) but is taken from the batches and
the benchmark's own view of the index, never from a kernel's arguments, so
it stays the same whatever kernel implements the join.  Per slave and
batch (one launch of the join a slave), each byte is counted once:

- every distinct driver window that the batch's queries read: its postings
  (4 bytes each), and their sites where a query of that driver is
  site-limited.  Under merge-on-read the window is the merged one: the
  main and delta postings that fill its ``window`` slots;
- under merge-on-read, the tombstone bits of the window's documents, by
  32-byte sector of the flag array;
- the probes: for each match, in each other term, the 32-byte sector of
  the list (main window, else delta list) that holds the matching docID,
  which any join must read to confirm it;
- the output: per query, its first ``k`` matches and its count, 4 bytes
  each.

Operations: one int32 comparison per window posting and list it is held
against.  The least time is the larger of bytes over HBM bandwidth and
operations over the int32 rate: what any kernel needs at least, so a share
of it never passes 100%.
"""
from __future__ import annotations

import numpy as np

from odys_bench import reference

#: One NVIDIA H100 SXM (data sheet, 700 W): HBM3 bandwidth and the
#: CUDA cores' int32 rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
SECTOR = 32
POSTINGS_PER_SECTOR = SECTOR // 4


def launch_work(main, state, s: int, queries, k: int) -> tuple[int, int]:
    """(bytes, operations) of slave ``s``'s join of one batch of
    ``(terms, site)`` queries at snapshot ``state``."""
    windows: dict[int, list] = {}
    flag_sectors: set[int] = set()
    probe_sectors: set[tuple] = set()
    out_bytes = ops = 0
    for terms, site in queries:
        j = reference.slave_join(main, state, s, list(terms), site)
        seen = windows.setdefault(j.driver, [j.n_main + j.n_delta, False])
        seen[1] |= site is not None
        if state is not None:
            flag_sectors.update((j.docs // POSTINGS_PER_SECTOR).tolist())
        hit = j.docs[j.match]
        for t, pm, pd in j.probes:
            at = np.minimum(np.searchsorted(pm, hit), max(pm.shape[0] - 1, 0))
            in_main = (pm[at] == hit) if pm.shape[0] else np.zeros(hit.shape, bool)
            at_d = np.searchsorted(pd, hit[~in_main])
            probe_sectors.update((t, 0, x) for x in
                                 (at[in_main] // POSTINGS_PER_SECTOR).tolist())
            probe_sectors.update((t, 1, x) for x in
                                 (at_d // POSTINGS_PER_SECTOR).tolist())
        out_bytes += 4 * (min(k, int(hit.shape[0])) + 1)
        ops += int(j.docs.shape[0]) * (1 + len(j.probes))
    win_bytes = sum(4 * n * (2 if sited else 1) for n, sited in windows.values())
    total = (win_bytes + SECTOR * len(flag_sectors) + SECTOR * len(probe_sectors)
             + out_bytes)
    return total, ops


def join_least_seconds(main, corpus, batches, mutations=None) -> float:
    """The least time of the slave join over ``batches``, each
    ``(queries, k, m)`` with ``m`` the mutations its snapshot holds."""
    seconds = 0.0
    ms = sorted({m for _, _, m in batches})
    by_m = {m: [b for b in batches if b[2] == m] for m in ms}
    for m, state in reference.snapshots(corpus, main.ns, mutations, ms):
        for queries, k, _ in by_m[m]:
            for s in range(main.ns):
                nbytes, ops = launch_work(main, state, s, queries, k)
                seconds += max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
    return seconds
