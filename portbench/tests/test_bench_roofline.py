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
