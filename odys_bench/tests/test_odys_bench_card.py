"""On a card: a small run of each cell through the kernels, correct and with
every device reading present."""
import pytest
from conftest import CELLS, run_small


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_small_cell_on_the_card(card, cell):
    res = run_small(cell, 2**31 + 21, seconds=3.0, trace=True, device=card)
    assert res["correct"], res["compared"]
    got = {k: v for k, (v, _) in res["metrics"].items()}
    assert 0 < got["join_roofline_pct"] <= 100
    assert 0 <= got["device_idle_pct"] < 100 and got["device_ops_per_batch"] > 0
