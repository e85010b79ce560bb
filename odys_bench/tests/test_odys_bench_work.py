"""The join's least work on hand-counted cases, and the trace reduction on
a hand-made trace."""
import json

import numpy as np

from odys_bench import data, profile, reference, work


def _corpus():
    # d0 {0,1} site 0; d1 {0} site 1; d2 {0,1} site 0; d3 {1,2} site 1
    terms = [[0, 1], [0], [0, 1], [1, 2]]
    offs = np.cumsum([0] + [len(t) for t in terms])
    return data.CorpusArrays(offs.astype(np.int64), np.concatenate(terms).astype(np.int32),
                             np.array([0, 1, 0, 1], np.int32), 3, 2)


def test_static_join_counts_windows_probes_and_outputs():
    c = _corpus()
    main = reference.MainLists(c, 1, 16, [0, 1, 2])
    # single term 0: its 3 postings (no site: no attrs), 3 hits + the count out
    assert work.launch_work(main, None, 0, [([0], None)], 10) == (3 * 4 + 4 * 4, 3)
    # terms [1, 0] at site 0: driver 1 (the first of equal lengths) with its
    # sites, 24 B; docs 0 and 2 confirmed in one sector of term 0; k 1 + count
    assert work.launch_work(main, None, 0, [([1, 0], 0)], 1) == (24 + 32 + 8, 6)
    # a window two queries share is read once; each writes its own output
    assert work.launch_work(main, None, 0, [([0], None), ([0], None)], 10) == (12 + 32, 6)


def test_merge_on_read_join_counts_the_delta_and_the_tombstones():
    c = _corpus()
    main = reference.MainLists(c, 1, 16, [0, 1, 2])
    state = reference.DeltaState(c, 1)
    state.apply(data.Mutation(data.INSERT, 4, np.array([0], np.int32), 1))
    # window [0, 1, 2, 4]: 3 main + 1 delta postings, one flag sector, 4 hits
    assert work.launch_work(main, state, 0, [([0], None)], 10) == (16 + 32 + 20, 4)
    state.apply(data.Mutation(data.DELETE, 1, np.zeros(0, np.int32), -1))
    # doc 1 keeps its slot, dead: 3 hits
    assert work.launch_work(main, state, 0, [([0], None)], 10) == (16 + 32 + 16, 4)
    seconds = work.join_least_seconds(main, c, [([([0], None)], 10, 2)], [
        data.Mutation(data.INSERT, 4, np.array([0], np.int32), 1),
        data.Mutation(data.DELETE, 1, np.zeros(0, np.int32), -1)])
    assert seconds == max(64 / work.HBM_BYTES_PER_S, 4 / work.INT32_OPS_PER_S)


def test_trace_reduction_unions_busy_time_and_names_gaps(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": profile.WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::foo", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "port.execute", "ts": 40, "dur": 60},
        {"ph": "X", "cat": "kernel", "name": "A(int const*)", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "void ns::B<4>(int)", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 10},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = profile.read_trace(path)
    assert t.window_s == 100e-6 and abs(t.busy_s - 40e-6) < 1e-12
    assert len(t.ops) == 3
    assert [g[0] for g in t.top_gaps()] == ["port.execute", "aten::foo"]
    assert abs(t.top_gaps()[0][1] - 50e-6) < 1e-12
    assert t.seconds_of(["A"]) == 20e-6 and t.seconds_of(["B"]) == 20e-6
    assert t.seconds_of(["A", "B", "C"]) == 40e-6
