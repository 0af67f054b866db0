"""The benchmark's kernel work functions give ``chip_smoke.py``'s numbers
on the same inputs."""
import sys

import numpy as np
import pytest
import torch

from benchcell import ROOT
from portbench import roofline

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _programs(b, w, mi, mf):
    return {"valid": torch.zeros((b, w), dtype=torch.float32),
            "imask": torch.zeros((b, w, mi), dtype=torch.int64),
            "flo": torch.zeros((b, w, mf), dtype=torch.float32),
            "fhi": torch.zeros((b, w, mf), dtype=torch.float32)}


@pytest.mark.parametrize("b,m,d,mi,mf", [(1024, 32, 128, 2, 1),
                                         (37, 16, 960, 2, 1),
                                         (5, 1, 19, 0, 3)])
def test_gather_distance_work_is_gd_bounds(b, m, d, mi, mf):
    rng = np.random.default_rng(b)
    ids = torch.as_tensor(rng.integers(-1, 1000, size=(b, m)))
    progs = _programs(b, 8, mi, mf)
    rates = {"f32_flops": roofline.PEAKS["f32_flops"],
             "hbm_bytes_per_s": roofline.PEAKS["hbm_bytes_per_s"]}
    want = chip_smoke.gd_bounds(rates, ids, d, mi, mf, progs)
    flops, nbytes = roofline.gather_distance_work(
        b, m, int((ids >= 0).sum()), d, mi, mf, w=8, id_bytes=8)
    assert 1e3 * roofline.bound_s(flops, nbytes) == pytest.approx(
        want["bound_ms"], rel=1e-12)
    assert roofline.program_bytes(b, 8, mi, mf) == sum(
        v.numel() * v.element_size() for v in progs.values())


def test_filtered_topk_bytes_are_the_smoke_tests():
    b, n, d, mi, mf, k = 1024, 4_000_000, 128, 2, 1, 10
    progs = _programs(b, 8, mi, mf)
    prog_bytes = sum(v.numel() * v.element_size() for v in progs.values())
    ft_bytes = n * 4 * (d + 1 + mi + mf) + b * d * 4 + prog_bytes + b * k * 8
    flops, nbytes = roofline.filtered_topk_work(b, n, d, mi, mf, k,
                                                passing=12345)
    assert nbytes == ft_bytes
    assert flops == 2 * d * 12345


@pytest.mark.parametrize("b,m,d,mi,mf", [(1024, 32, 128, 2, 1),
                                         (7, 16, 960, 2, 1)])
def test_traversal_gather_work_of_one_full_block(b, m, d, mi, mf):
    """A traversal whose rows fill one (B, M) block with no -1 id needs
    what ``gd_bounds`` charges that block."""
    ids = torch.arange(b * m).reshape(b, m)
    rates = {"f32_flops": roofline.PEAKS["f32_flops"],
             "hbm_bytes_per_s": roofline.PEAKS["hbm_bytes_per_s"]}
    want = chip_smoke.gd_bounds(rates, ids, d, mi, mf, _programs(b, 8, mi, mf))
    flops, nbytes = roofline.traversal_gather_work(b, b * m, d, mi, mf)
    assert 1e3 * roofline.bound_s(flops, nbytes) == pytest.approx(
        want["bound_ms"], rel=1e-12)


def test_pq_adc_topr_bytes_are_the_smoke_tests():
    """At the kernel table's shape: B 1024, N 4M, M 32, K 256, R 80."""
    b, n, mi, mf = 1024, 4_000_000, 2, 1
    m, ksub, r = chip_smoke.PQ_M, 1 << chip_smoke.PQ_BITS, \
        chip_smoke.RERANK * chip_smoke.K
    assert (m, ksub, r) == (32, 256, 80)
    progs = _programs(b, 8, mi, mf)
    prog_bytes = sum(v.numel() * v.element_size() for v in progs.values())
    luts_numel = b * m * ksub
    topr_bytes = (n * (m + 4 * (1 + mi + mf)) + luts_numel * 4
                  + prog_bytes + b * r * 8)
    ops, nbytes = roofline.pq_adc_topr_work(b, n, m, ksub, mi, mf, r,
                                            passing=b * n)
    assert nbytes == topr_bytes
    assert ops == b * n * m         # the smoke test's count: every pair


@pytest.mark.parametrize("b,m0,mi,mf", [(1024, 32, 2, 1), (7, 16, 0, 3)])
def test_traversal_pq_gather_work_of_one_full_block(b, m0, mi, mf):
    """A traversal whose rows fill one (B, M0) block with no -1 id needs
    what ``pq_gather_bounds`` charges that block (dense + scattered)."""
    m, ksub = chip_smoke.PQ_M, 1 << chip_smoke.PQ_BITS
    ids = torch.arange(b * m0).reshape(b, m0)
    rng = np.random.default_rng(b)
    codes = torch.as_tensor(rng.integers(0, ksub, size=(b * m0, m)),
                            dtype=torch.uint8)
    luts = torch.zeros((b, m, ksub), dtype=torch.bfloat16)
    rates = {"f32_flops": roofline.PEAKS["f32_flops"],
             "hbm_bytes_per_s": roofline.PEAKS["hbm_bytes_per_s"]}
    want = chip_smoke.pq_gather_bounds(rates, ids, codes, luts, mi, mf,
                                       _programs(b, 8, mi, mf))
    assert want["bound_by"] == "bytes"
    ops, nbytes = roofline.traversal_pq_gather_work(b, b * m0, m, ksub, mi,
                                                    mf, lut_bytes=2)
    assert 1e3 * roofline.bound_s(ops, nbytes) == pytest.approx(
        want["bound_ms"], rel=1e-12)


def test_pq_work_counted_by_hand():
    # 3 queries over 5 rows of 4 codes (K 16), 1 int and 2 float columns,
    # programs of width 2, R 2, 7 passing pairs
    ops, nbytes = roofline.pq_adc_topr_work(3, 5, 4, 16, 1, 2, 2, passing=7,
                                            w=2)
    assert ops == 7 * 4
    rows = 5 * (4 + 4 * (1 + 1 + 2))
    tables = 3 * 4 * 16 * 4
    programs = 3 * 2 * 4 + 3 * 2 * 1 * 8 + 2 * 3 * 2 * 2 * 4
    assert nbytes == rows + tables + programs + 3 * 2 * 8
    # 2 queries scoring 10 rows on bf16 tables: each row's code row,
    # attributes, id, 4 table entries, its key and TD byte
    ops, nbytes = roofline.traversal_pq_gather_work(2, 10, 4, 16, 1, 2, 2,
                                                    w=2)
    assert ops == 10 * 4
    dense = 2 * 4 + 2 * 2 * 4 + 2 * 2 * 1 * 8 + 2 * 2 * 2 * 2 * 4
    per_row = 4 + 4 * (1 + 2) + 8 + 5
    assert nbytes == dense + 10 * 4 * 2 + 10 * per_row
    # 100 rows look up more entries than the 2 x 4 x 16 tables hold
    ops, nbytes = roofline.traversal_pq_gather_work(2, 100, 4, 16, 1, 2, 2,
                                                    w=2)
    assert ops == 100 * 4
    assert nbytes == dense + 2 * 4 * 16 * 2 + 100 * per_row
