"""The frozen generators draw the stated shares and skews, the same for the
same seed."""
import json

import numpy as np
import pytest
from conftest import ROOT

from odys_bench import data

CFG = json.loads((ROOT / "odys_bench/configs/odys-static-4x1M.json").read_text())
MIX = json.loads((ROOT / "odys_bench/traffic/paper-mix.json").read_text())
UPD = json.loads((ROOT / "odys_bench/configs/odys-mor-4x1M.json").read_text())["writer"]["mutation_mix"]


@pytest.fixture(scope="module")
def corpus():
    cfg = dict(CFG, n_docs=40_000, vocab_size=5_000, n_sites=200)
    return cfg, data.make_corpus(cfg, 2**31 + 7, "cpu")


def test_corpus_shape_lengths_and_skews(corpus):
    cfg, c = corpus
    assert c.n_docs == 40_000 and c.doc_offsets[-1] == c.doc_terms.shape[0]
    lens = np.diff(c.doc_offsets)
    assert lens.min() >= 1
    for d in range(0, c.n_docs, 997):
        row = c.doc_terms[c.doc_offsets[d]:c.doc_offsets[d + 1]]
        assert (np.diff(row) > 0).all()          # unique, ascending
    # Zipf 1.1 terms: the hottest term is in nearly every page, and a
    # term's page count falls with its rank
    df = np.bincount(c.doc_terms, minlength=c.vocab_size)
    assert df[0] > 0.95 * c.n_docs
    assert df[:10].mean() > df[100:110].mean() > df[1000:1010].mean()
    # distinct terms a page: 64 Poisson draws less the repeats of hot terms
    assert 30 < lens.mean() < 64
    # Zipf 1.2 site sizes: site 0 holds p_0 of the pages
    p0 = 1 / (np.arange(1, c.n_sites + 1, dtype=float) ** -1.2).sum()
    assert abs((c.doc_site == 0).mean() - p0) < 0.01


def test_corpus_repeats_for_a_seed_and_moves_with_it(corpus):
    cfg, c = corpus
    again = data.make_corpus(cfg, 2**31 + 7, "cpu")
    other = data.make_corpus(cfg, 2**31 + 8, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(c[:3], again[:3]))
    assert not np.array_equal(c.doc_site, other.doc_site)


def test_queries_draw_the_papers_mix():
    q = data.make_queries(MIX, CFG, 5, 200_000)
    kinds = {}
    for sct, k, p in MIX["mix"]:
        kinds[(sct, k)] = p
    single = q.n_terms == 1
    limited = q.site >= 0
    for (sct, k), p in kinds.items():
        is_sct = {"single": single & ~limited, "limited": limited,
                  "multiple": ~single & ~limited}[sct]
        share = (is_sct & (q.k == k)).mean()
        assert abs(share - p) < 0.005, (sct, k, share, p)
    assert set(np.unique(q.n_terms[~single])) == {2, 3}
    rows = q.terms[~single]
    a, b = rows[:, 0], rows[:, 1]
    assert (a != b).all() and ((rows[:, 2] < 0) | ((rows[:, 2] != a) & (rows[:, 2] != b))).all()
    assert q.terms[single][:, 1:].max() == -1
    assert q.site[limited].min() >= 0 and q.site[limited].max() < CFG["n_sites"]
    assert (q.terms[:, 0] == 0).mean() > 0.05      # Zipf: term 0 is the hottest
    again = data.make_queries(MIX, CFG, 5, 200_000)
    assert all(np.array_equal(x, y) for x, y in zip(q, again))


def test_mutations_draw_the_update_mix_over_live_pages(corpus):
    _, c = corpus
    muts = data.make_mutations(UPD, c, 9, 6000)
    ops = np.array([m.op for m in muts])
    for op, p in ((data.INSERT, UPD["p_insert"]), (data.DELETE, UPD["p_delete"]),
                  (data.UPDATE, UPD["p_update"])):
        assert abs((ops == op).mean() - p) < 0.03
    live = set(range(c.n_docs))
    nxt = c.n_docs
    moved = []
    for m in muts:
        if m.op == data.INSERT:
            assert m.gid == nxt and 0 <= m.site < c.n_sites
            live.add(nxt)
            nxt += 1
        else:
            assert m.gid in live
            if m.op == data.DELETE:
                live.remove(m.gid)
            else:
                moved.append(m.site >= 0)
        if m.op != data.DELETE:
            assert (np.diff(m.terms) > 0).all() and m.terms.size >= 1
    assert abs(np.mean(moved) - UPD["p_site_change"]) < 0.04
