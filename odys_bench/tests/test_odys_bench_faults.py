"""The check fails a run whose timed path is broken underneath, and the
control (the reference with a stated guarantee broken) fails it too."""
import pytest
from conftest import run_small, small_cell

import repro_torch.core.engine as engine
import repro_torch.core.parallel as parallel
from odys_bench import control
from repro_torch.serving.search import SearchHit

MOR = "mor-4x1M.paper-mix-ingest"
STATIC = "static-4x1M.paper-mix"


def stale_publish(s):
    """A publish that returns the snapshot unchanged."""
    first = s.svc.writer.device_delta()
    s.svc.writer.device_delta = lambda: first


def half_batch(s):
    """The engine answers the first half of each batch; the rest go empty."""
    run = s.sched.executor

    def executor(queries, t_max, k, set_id):
        half = len(queries) // 2
        kept = queries[:half] + [queries[0]] * (len(queries) - half)
        return run(kept, t_max, k, set_id)[:half] + [SearchHit([], 0)] * (
            len(queries) - half)

    s.sched.executor = executor


def test_a_publish_that_leaves_the_snapshot_unchanged_fails():
    res = run_small(MOR, 101, faults=stale_publish)
    assert not res["correct"] and res["compared"]["readback_mismatch"][0] > 0


@pytest.mark.parametrize("cell", [STATIC, MOR])
def test_half_the_batch_left_out_fails(cell):
    res = run_small(cell, 102, faults=half_batch)
    assert not res["correct"] and res["compared"]["window_mismatch"][0] > 0


def test_the_exchange_between_slaves_left_out_fails(monkeypatch):
    merge = parallel.tournament_merge

    def without_last_round(cands, ns, **kw):
        return merge(cands[: ns // 2], ns // 2, **kw)   # slaves 2, 3 never sent

    monkeypatch.setattr(parallel, "tournament_merge", without_last_round)
    res = run_small(STATIC, 103)
    assert not res["correct"] and res["compared"]["window_mismatch"][0] > 0


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    first_k = engine._first_k_by_rank

    def one_more_hit(docids, mask, k):
        out, hits = first_k(docids, mask, k)
        return out, hits + 1

    monkeypatch.setattr(engine, "_first_k_by_rank", one_more_hit)
    res = run_small(STATIC, 104)
    assert not res["correct"] and res["compared"]["window_mismatch"][0] > 0


@pytest.mark.parametrize("cell", [STATIC, MOR])
def test_the_control_fails_the_check(cell):
    config, _ = small_cell(cell)
    for seed in (7, 8, 9):
        res = run_small(cell, seed, faults=control.control_of(config))
        assert not res["correct"], res["compared"]
