"""Port parity, roofline: ``repro_torch.roofline``.  The collective parser
is a copy of the JAX package's pure-text one, pinned to it on the texts of
``tests/test_roofline.py``; the three terms use the H100 constants; the
report renders the port's records."""
import inspect
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.roofline import analysis as RA  # noqa: E402
from repro_torch.roofline import analysis as PA  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402
from repro_torch.roofline import report  # noqa: E402

HLO = """
  %all-reduce.8 = (f32[4096,39,10]{2,1,0}, f32[4096,39,1]{2,1,0}) all-reduce(%a, %b), replica_groups=[16,16]<=[256], use_global_device_ids=true
  %all-reduce.1 = f32[16,4096,2304]{2,1,0} all-reduce(%c), channel_id=1, replica_groups=[16,16]<=[256]
  %ag = bf16[26,2304,4,256]{3,2,1,0} all-gather(%d), replica_groups=[8,32]<=[256], dimensions={1}
  %rs = f32[64,128]{1,0} reduce-scatter(%e), replica_groups=[16,16]<=[256]
  %a2a = f32[64,128]{1,0} all-to-all(%f), replica_groups=[16,16]<=[256]
  %cp = f32[64,128]{1,0} collective-permute(%g), source_target_pairs={{0,1}}
  %ard = f32[8]{0} all-reduce-done(%x)
  %ars = f32[8]{0} all-reduce-start(%y), replica_groups={{0,1},{2,3}}
"""
NOT_COLLECTIVES = """
  %dot.1 = f32[128,128]{1,0} dot(%a, %b), lhs_contracting_dims={1}
  %fusion.2 = f32[64]{0} fusion(%all), calls=%computation_with_all_gather_name
"""


@pytest.mark.parametrize("name", ["_shape_bytes", "_group_size",
                                  "parse_collectives"])
def test_parser_is_a_copy_of_the_reference(name):
    assert inspect.getsource(getattr(PA, name)) == \
        inspect.getsource(getattr(RA, name))
    assert PA._DTYPE_BYTES == RA._DTYPE_BYTES
    assert PA._OPS == RA._OPS
    assert PA._SHAPE_RE.pattern == RA._SHAPE_RE.pattern
    assert PA._GROUPS_RE.pattern == RA._GROUPS_RE.pattern


@pytest.mark.parametrize("text,n", [(HLO, 256), (NOT_COLLECTIVES, 16),
                                    (HLO, 8)])
def test_parse_collectives_matches_reference(text, n):
    ref, got = RA.parse_collectives(text, n), PA.parse_collectives(text, n)
    assert got.counts == ref.counts
    assert got.by_op == ref.by_op
    assert got.link_bytes == ref.link_bytes and got.raw_bytes == ref.raw_bytes


def test_parse_single_and_tuple_collectives():
    st = PA.parse_collectives(HLO, 256)
    assert st.counts == {"all-reduce": 3, "all-gather": 1, "reduce-scatter": 1,
                         "all-to-all": 1, "collective-permute": 1}
    exp = (2 * (15 / 16) * (4096 * 39 * 10 * 4 + 4096 * 39 * 1 * 4)
           + 2 * (15 / 16) * (16 * 4096 * 2304 * 4)
           + (31 / 32) * (26 * 2304 * 4 * 256 * 2)
           + 15 * (64 * 128 * 4)
           + (15 / 16) * (64 * 128 * 4)
           + 64 * 128 * 4
           + 2 * (1 / 2) * 32)
    np.testing.assert_allclose(st.link_bytes, exp, rtol=1e-9)


def test_group_size_formats():
    assert PA._group_size("[16,16]<=[256]", 999) == 16
    assert PA._group_size("{{0,1,2,3}}", 999) == 4
    assert PA._group_size(None, 77) == 77


def test_h100_constants():
    """The H100 SXM5 data sheet's dense bf16 rate, HBM rate and size, and
    one NVLink-4 link of 18 sharing 900 GB/s."""
    assert hw.PEAK_FLOPS_BF16 == 989.4e12
    assert hw.HBM_BW == 3.35e12
    assert hw.HBM_PER_CHIP == 80e9
    assert hw.NVLINK_LINK_BW == 50e9
    assert not hasattr(hw, "ICI_LINK_BW")


def test_roofline_terms_and_bottleneck():
    r = PA.Roofline(flops=hw.PEAK_FLOPS_BF16, hbm_bytes=hw.HBM_BW / 2,
                    coll_link_bytes=hw.NVLINK_LINK_BW / 4, n_devices=256,
                    collectives={}, model_flops=hw.PEAK_FLOPS_BF16 * 128)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 0.5) < 1e-9
    assert abs(r.t_collective - 0.25) < 1e-9
    assert r.bottleneck == "compute"
    assert abs(r.useful_flops_frac - 0.5) < 1e-9
    assert abs(r.roofline_frac - 0.5) < 1e-9
    # the same terms as the reference's Roofline over the same numbers,
    # each on its own hardware constants
    ref = RA.Roofline(flops=1.0, hbm_bytes=1.0, coll_link_bytes=0.0,
                      n_devices=4, collectives={}, model_flops=2.0)
    got = PA.Roofline(flops=1.0, hbm_bytes=1.0, coll_link_bytes=0.0,
                      n_devices=4, collectives={}, model_flops=2.0)
    assert ref.to_dict().keys() == got.to_dict().keys()
    assert got.useful_flops_frac == ref.useful_flops_frac


def test_analyze_divides_the_count_evenly():
    """A single controller's count of every mesh cell's program is divided
    evenly by the programs it covers, collectives included; a partitioned
    count is one device's program and is taken as given."""
    coll = {"counts": {"all-gather": 512}, "by_op": {"all-gather": 2.56e6}}
    cost = PA.Cost(flops=8e15, bytes_accessed=4e12, argument_bytes=1024,
                   output_bytes=512, coll_link_bytes=2.56e6,
                   collectives=coll, temp_bytes=64)
    r = PA.analyze(cost, 256, model_flops=4e15, programs=256)
    assert r.flops == 8e15 / 256 and r.hbm_bytes == 4e12 / 256
    assert r.coll_link_bytes == 1e4
    assert r.t_collective == pytest.approx(1e4 / 50e9)
    assert r.collectives == {"counts": {"all-gather": 2},
                             "by_op": {"all-gather": 1e4}}
    assert r.useful_flops_frac == 0.5
    assert r.t_compute == pytest.approx(8e15 / 256 / 989.4e12)
    given = PA.analyze(cost, 256, model_flops=4e15)
    assert (given.flops, given.hbm_bytes, given.coll_link_bytes) == \
        (8e15, 4e12, 2.56e6)
    assert PA.memory_analysis_dict(cost) == {
        "argument_size_in_bytes": 1024, "output_size_in_bytes": 512,
        "temp_size_in_bytes": 64}


def test_report_renders_port_records(tmp_path, monkeypatch, capsys):
    cost = PA.Cost(flops=2e15, bytes_accessed=1e12, argument_bytes=3 * 2**30,
                   output_bytes=0)
    recs = [{"arch": "a", "shape": "s", "mesh": "16x16", "ok": True,
             "roofline": PA.analyze(cost, 256, 1e15, programs=256).to_dict(),
             "memory": PA.memory_analysis_dict(cost)},
            {"arch": "b", "shape": "s", "mesh": "16x16", "ok": True,
             "skipped": "why"},
            {"arch": "c", "shape": "s", "mesh": "16x16", "ok": False}]
    text = report.table(recs, "16x16")
    assert "| a | s |" in text and "compute" in text and "skip" in text
    assert "| c | s | FAIL" in text
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(recs))
    monkeypatch.setattr("sys.argv", ["report", str(path)])
    report.main()
    out = capsys.readouterr().out
    assert "## Roofline -- mesh 16x16 (2/3 cells ok)" in out and text in out
    assert report.fmt_bytes(3 * 2**30 / 256) == "12.0MB"
