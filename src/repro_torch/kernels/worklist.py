"""Work-list compaction: the host-side builder of the compacted kernels'
descriptor tables (the port's copy of ``repro.kernels.worklist``).

The dense kernels K1, K3 and K4 launch grids shaped by the batch: every
query of a bucket, every driver tile, every term slot.  Inert padding
queries (the clones the scheduler adds to fill a partial bucket), absent
term slots and empty probe spans still cost grid steps there.  This module
enumerates only the live ``(query, driver tile)`` and ``(query, term,
probe tile)`` work items, from the probe plans the engine already computes,
and packs them into a dense int32 descriptor table; the compacted kernels
K6, K7 and K8 run over that table, so inert work costs no step at all.

Descriptor row layout (``desc[n]``, int32[8]):

==  =======================================================================
 0  query index ``q``
 1  driver/window tile index ``i`` (the output block row)
 2  term slot ``t`` (bounds lookup; 0 when no term is probed)
 3  absolute main-stream probe tile, ``-1`` = no main probe this step
 4  step flags (see below)
 5  absolute delta-stream probe tile, ``-1`` = no delta probe this step
 6  reserved (0)
 7  reserved (0)
==  =======================================================================

Flags mark the per-(q, i) state-machine edges: ``FLAG_FIRST`` (first item
of the output block: initialise it), ``FLAG_TERM_START`` (reset the term's
membership), ``FLAG_TERM_END`` (AND the term's membership into the mask),
``FLAG_LAST`` (last item of the block: finalise and write it).  One item
may carry all four.

The table is row for row the reference builder's (the CPU tests hold it
so), padding included:

- items are grouped by (q, i) in ascending order, each group opening with
  ``FLAG_FIRST`` and closing with ``FLAG_LAST``;
- the table has :func:`worklist_pad` rows; padding rows clone the last real
  item with both probe fields ``-1`` and flags 0.  The port's kernels never
  walk them (a thread block takes one group, from its head to its end);
- an all-inert batch yields ``n_items == 0``, and the caller launches
  nothing.

The builders are numpy, vectorised over (query, tile, term); at main-path
shapes a table has at most Q*A*T*(A+1) = 32*4*4*5 = 2,560 rows.  Every
build sets the ``odys_kernel_grid_occupancy`` gauge (live items over
dense-grid steps) and adds to the ``odys_kernel_steps_saved_total``
counter, under the reference's ``kernel=`` label names.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.obs.registry import get_registry

__all__ = [
    "DESC_COLS",
    "FLAG_FIRST",
    "FLAG_LAST",
    "FLAG_TERM_END",
    "FLAG_TERM_START",
    "WorkList",
    "build_intersect_worklist",
    "build_merge_worklist",
    "live_rows",
    "output_rows",
    "plan_to_host",
    "table_items",
    "table_to_device",
    "worklist_pad",
]

DESC_COLS = 8

FLAG_FIRST = 1       # first item of (q, i): init output accumulators
FLAG_TERM_START = 2  # reset the per-term membership scratch
FLAG_TERM_END = 4    # AND-fold the term's membership into the mask
FLAG_LAST = 8        # last item of (q, i): finalize / merge / emit output


def worklist_pad(n_items: int) -> int:
    """Padded descriptor-table length: the next power of two holding at
    least one spare entry past the live items."""
    return 1 << int(n_items).bit_length()


@dataclass(frozen=True)
class WorkList:
    """A built descriptor table plus its occupancy accounting."""

    desc: np.ndarray      # int32[worklist_pad(n_items), DESC_COLS]
    n_items: int          # live rows (rows past this are no-op padding)
    dense_steps: int      # grid steps the dense comparator would launch

    @property
    def occupancy(self) -> float:
        return self.n_items / self.dense_steps if self.dense_steps else 0.0

    def group_heads(self) -> np.ndarray:
        """int32[n_groups + 1]: the row of each (q, i) group's
        ``FLAG_FIRST`` item, then ``n_items``; group ``g`` is the rows
        ``heads[g] .. heads[g + 1] - 1``."""
        first = np.flatnonzero(self.desc[: self.n_items, 4] & FLAG_FIRST)
        return np.append(first, self.n_items).astype(np.int32)


def _finish(rows: np.ndarray, *, kernel: str, dense_steps: int) -> WorkList:
    """Pad the item rows (int32[n, DESC_COLS]) to :func:`worklist_pad`
    rows and emit the occupancy metrics."""
    n_items = rows.shape[0]
    desc = np.zeros((worklist_pad(n_items), DESC_COLS), dtype=np.int32)
    if n_items:
        desc[:n_items] = rows
        # Padding clones the last real item as a no-op: same (q, i), probe
        # fields -1 and flags 0.
        pad = desc[n_items - 1].copy()
        pad[3] = -1
        pad[4] = 0
        pad[5] = -1
        desc[n_items:] = pad
    else:
        desc[:, 3] = -1
        desc[:, 5] = -1

    reg = get_registry()
    reg.gauge(
        "odys_kernel_grid_occupancy",
        help="live work items / dense-grid steps of the last built work list",
        kernel=kernel,
    ).set(n_items / dense_steps if dense_steps else 0.0)
    reg.counter(
        "odys_kernel_steps_saved_total",
        help="dense-grid steps elided by work-list compaction",
        kernel=kernel,
    ).inc(max(dense_steps - n_items, 0))
    return WorkList(desc=desc, n_items=n_items, dense_steps=dense_steps)


def _live(live_q, q_n: int) -> np.ndarray:
    return np.ones(q_n, bool) if live_q is None else np.asarray(live_q, bool)


def build_intersect_worklist(
    n_b: np.ndarray,        # int32[Q, T, num_a]  main probe tiles per item
    b_tile: np.ndarray,     # int32[Q, T, num_a]  first main probe tile
    active: np.ndarray,     # int32[Q, T]         1 iff slot t joins query q
    a_any: np.ndarray,      # bool[Q, num_a]      driver tile holds live postings
    *,
    n_d: np.ndarray | None = None,     # delta probe plan (merge-on-read)
    d_tile: np.ndarray | None = None,
    live_q: np.ndarray | None = None,  # bool[Q]; None = every query live
    kernel: str,
    dense_steps: int,
) -> WorkList:
    """Work list of a compacted join (K6, or K7 with the delta plan; raw or
    packed: the plans do not depend on the codec).

    Per live query and driver tile, in (q, i, t) order, one item per probe
    step of each active term, main and delta tiles advancing in lockstep
    (``max(n_b, n_d)`` steps).  Instead:

    - an inert query (``live_q`` false) has no item;
    - a driver tile with no live posting, or a query with no active term,
      has one ``FIRST|LAST`` item (term 0, no probe): its mask is the fused
      validity and filter predicate;
    - a tile where an active term has no probe at all has one
      ``FIRST|TERM_START|TERM_END|LAST`` item naming the first such term:
      its mask is all zero.
    """
    n_b = np.asarray(n_b, np.int64)
    b_tile = np.asarray(b_tile, np.int64)
    act = np.asarray(active) != 0                         # [Q, T]
    a_any = np.asarray(a_any, bool)                       # [Q, A]
    q_n, t_n, num_a = n_b.shape
    nd = np.zeros_like(n_b) if n_d is None else np.asarray(n_d, np.int64)
    dt = np.zeros_like(n_b) if d_tile is None else np.asarray(d_tile, np.int64)
    # everything below in (q, i, t) order, the order of the rows
    nm, nd, bt, dt = (x.transpose(0, 2, 1) for x in (n_b, nd, b_tile, dt))
    act3 = np.broadcast_to(act[:, None, :], nm.shape)
    steps = np.where(act3, np.maximum(nm, nd), 0)
    noop = ~a_any | ~act.any(1)[:, None]                  # [Q, A]
    zero = act3 & (steps == 0)
    dead = zero.any(2) & ~noop
    special = noop | dead
    # rows per (q, i, t): the probe steps, or the one special item
    t_special = np.where(dead, zero.argmax(2), 0)         # [Q, A]
    one_hot = np.arange(t_n) == t_special[..., None]
    count = np.where(special[..., None], one_hot, steps)
    count = count * _live(live_q, q_n)[:, None, None]
    cnt = count.reshape(-1)
    n_items = int(cnt.sum())
    rows = np.zeros((n_items, DESC_COLS), np.int64)
    if n_items:
        cell = np.repeat(np.arange(cnt.size), cnt)        # (q, i, t) per row
        start = np.cumsum(cnt) - cnt
        s = np.arange(n_items) - start[cell]              # step within cell
        q, rem = np.divmod(cell, num_a * t_n)
        i, t = np.divmod(rem, t_n)
        spec = special[q, i]
        m_n, d_n = nm.reshape(-1)[cell], nd.reshape(-1)[cell]
        last_s = np.maximum(m_n, d_n) - 1
        rows[:, 0], rows[:, 1], rows[:, 2] = q, i, t
        rows[:, 3] = np.where(~spec & (s < m_n), bt.reshape(-1)[cell] + s, -1)
        rows[:, 5] = np.where(~spec & (s < d_n), dt.reshape(-1)[cell] + s, -1)
        flags = np.where(s == 0, FLAG_TERM_START, 0) | np.where(
            s == last_s, FLAG_TERM_END, 0)
        flags = np.where(spec, np.where(dead[q, i], FLAG_TERM_START
                                        | FLAG_TERM_END, 0), flags)
        group = q * num_a + i
        new = np.ones(n_items, bool)
        new[1:] = group[1:] != group[:-1]
        end = np.ones(n_items, bool)
        end[:-1] = new[1:]
        rows[:, 4] = flags | np.where(new, FLAG_FIRST, 0) | np.where(end, FLAG_LAST, 0)
    return _finish(rows.astype(np.int32), kernel=kernel, dense_steps=dense_steps)


def build_merge_worklist(
    m_neff: np.ndarray,     # int32[Q]  live main postings per driver window
    *,
    tile: int,              # postings per window tile (TILE)
    s_w: int,               # window tiles the dense grid sweeps per query
    live_q: np.ndarray | None = None,
    kernel: str,
    dense_steps: int,
) -> WorkList:
    """Work list of the delta merge (K8): one item per window tile that
    overlaps the query's live main range, at least one per live query (an
    empty main window still merges the delta slab), ``FLAG_LAST`` on the
    item that finishes the merge."""
    m_neff = np.asarray(m_neff, np.int64)
    n_tiles = np.clip(-(-m_neff // tile), 1, s_w) * _live(live_q, m_neff.shape[0])
    n_items = int(n_tiles.sum())
    rows = np.zeros((n_items, DESC_COLS), np.int64)
    if n_items:
        q = np.repeat(np.arange(m_neff.shape[0]), n_tiles)
        j = np.arange(n_items) - (np.cumsum(n_tiles) - n_tiles)[q]
        rows[:, 0], rows[:, 1] = q, j
        rows[:, 3] = rows[:, 5] = -1
        rows[:, 4] = np.where(j == 0, FLAG_FIRST, 0) | np.where(
            j == n_tiles[q] - 1, FLAG_LAST, 0)
    return _finish(rows.astype(np.int32), kernel=kernel, dense_steps=dense_steps)


def plan_to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """The plan tensors a builder needs, on the host as int32 arrays, in one
    device-to-host copy (the reference's single ``jax.device_get``): they
    are flattened into one int32 tensor on their device, copied, and
    split."""
    host = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors]).cpu().numpy()
    out, o = [], 0
    for t in tensors:
        out.append(host[o:o + t.numel()].reshape(tuple(t.shape)))
        o += t.numel()
    return out


def table_to_device(wl: WorkList, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(desc, heads)`` of a non-empty work list on ``device``, in one
    host-to-device copy: the table, int32[worklist_pad(n_items), 8], and
    its group heads (:meth:`WorkList.group_heads`)."""
    desc = wl.desc.reshape(-1)
    buf = torch.from_numpy(np.concatenate([desc, wl.group_heads()])).to(device)
    return buf[: desc.size].view(wl.desc.shape), buf[desc.size:]


def live_rows(live_q, q_n: int) -> np.ndarray | None:
    """``live_q`` (None, a sequence, a numpy array or a tensor) as a host
    bool[Q] array, or None when every query is live."""
    if live_q is None:
        return None
    if isinstance(live_q, torch.Tensor):
        live_q = live_q.cpu().numpy()
    live = np.asarray(live_q, dtype=bool)
    if live.shape != (q_n,):
        raise ValueError(f"live_q has shape {live.shape}, expected ({q_n},)")
    return live


def table_items(desc: torch.Tensor, heads: torch.Tensor):
    """``(items, group, gq, gi)`` of a table on its device: its live rows
    (int64 [N, 8]), each row's group, and each group's query and tile (the
    plain versions of the compacted kernels execute the table from these)."""
    items = desc[: int(heads[-1])].long()
    group = torch.cumsum((items[:, 4] & FLAG_FIRST) != 0, 0) - 1
    first = desc[heads[:-1].long()].long()
    return items, group, first[:, 0], first[:, 1]


def output_rows(q_n: int, width: int, every_row: bool, fills, device):
    """The output rows ``[Q, width]`` of a compacted kernel, one int32
    tensor per inert-row value in ``fills``: left empty when the groups
    write ``every_row`` of the output, else filled with that value (inert
    queries have no group)."""
    if every_row:
        return [torch.empty((q_n, width), dtype=torch.int32, device=device)
                for _ in fills]
    return [torch.full((q_n, width), f, dtype=torch.int32, device=device)
            for f in fills]
