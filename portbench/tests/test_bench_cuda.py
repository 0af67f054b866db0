"""The harness on the card at a reduced size, traced: every per-layer
reader finds its numbers.  Skips without a card.

200,000 rows with the configuration's own graph parameters, so that the
rows (100 MB at d = 128, 768 MB at d = 960) exceed the card's 50 MB L2,
and the window holds the traced batches.  Only the graph cell's sample is judged whole: at this size the
selector's 2,000-row sample can send a 0.5 % filter to the graph route,
whose answer may then hold fewer than k ids; the checks that hold on
either route (no wrong id, exact distances) are judged in both."""
import pytest
import torch

from benchcell import tiny
from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("traffic,dim,kernel", [
    ("paper-graph.b10000", 128, "gather_distance_roofline"),
    ("lowsel.b1000", 960, "filtered_topk_roofline")])
def test_traced_run_on_the_card(traffic, dim, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, trf = tiny(traffic=traffic, small_graph=False, n=200_000, dim=dim)
    trf.update(batch=256, trace_batches=2)
    fields, ctx, numbers = harness.run_cell(
        cfg, trf, seed=5, seconds=15.0, trace=True, device="cuda",
        log=lambda s: None)
    got = {name: value for name, value, _ in numbers}
    assert got["bad_ids"] == 0 and got["dist_gap"] <= cfg["limits"]["dist_gap"]
    if traffic.startswith("paper"):
        assert fields["correct"], numbers
    tr = ctx["trace"]
    assert 0 < tr["busy_s"] <= tr["window_s"]
    metrics = harness.BENCH_DIR / "metrics"
    for name in ("router.compile_ms_per_kq", "router.brute_pct",
                 "device.idle_pct", kernel):
        value = harness.load_reader(name, metrics).read(ctx)
        assert value is not None, name
    share = harness.load_reader(kernel, metrics).read(ctx)
    assert 0 < share <= 105, share
