"""Peaks of the card and the work of the port's kernels, counted from the
call's shapes and the filters' passing counts: each input byte read once,
each output byte written once, and the operations these inputs need,
whatever kernel computes them.

The gather count is ``chip_smoke.py``'s ``gd_bounds`` (its data-sheet
bound) and the scan's bytes ``chip_smoke.py``'s ``ft_bytes``; the two PQ
kernels' bytes are its ``topr_bytes`` and ``pq_gather_bounds``, copied here
so that the yardstick stays with the benchmark.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense, at the full power limit (700 W):
# float32 outside the tensor cores, TF32 on them, HBM3 bandwidth.
PEAKS = {"f32_flops": 67e12, "tf32_flops": 495e12, "hbm_bytes_per_s": 3.35e12}

PROGRAM_WIDTH = 8      # DNF width of the port's compiled filter programs


def program_bytes(b: int, w: int, mi: int, mf: int) -> int:
    """A stacked filter program's bytes for ``b`` queries: valid (B, W) f32,
    imask (B, W, m_i) int64, flo and fhi (B, W, m_f) f32."""
    return b * w * 4 + b * w * mi * 8 + 2 * b * w * mf * 4


def gather_distance_work(b: int, m: int, n_valid: int, d: int, mi: int,
                         mf: int, w: int = PROGRAM_WIDTH,
                         id_bytes: int = 8) -> tuple[int, int]:
    """(FLOPs, bytes) of one ``gather_distance`` call on a (B, M) id block
    with ``n_valid`` ids >= 0: each valid id's row, norm and attributes,
    the ids, the queries and D, the programs, and dbar and the TD byte out;
    one d-long multiply-add per valid id."""
    dense = (b * m * id_bytes + b * (d + 1) * 4 + program_bytes(b, w, mi, mf)
             + b * m * 5)
    scattered = n_valid * 4 * (d + 1 + mi + mf)
    return 2 * n_valid * d, dense + scattered


def traversal_gather_work(b: int, rows: int, d: int, mi: int, mf: int,
                          w: int = PROGRAM_WIDTH,
                          id_bytes: int = 8) -> tuple[int, int]:
    """(FLOPs, bytes) of the ``gather_distance`` work a graph traversal of
    ``b`` queries needs, whatever blocks it is cut into: ``rows`` the
    neighbour rows its expansions score (an expansion's M0-long list each),
    every such row, norm, attributes and id read once and its key and TD
    byte written once; the queries, D and their programs read once; one
    d-long multiply-add per row."""
    dense = b * (d + 1) * 4 + program_bytes(b, w, mi, mf)
    scattered = rows * (4 * (d + 1 + mi + mf) + id_bytes + 5)
    return 2 * rows * d, dense + scattered


def filtered_topk_work(b: int, n: int, d: int, mi: int, mf: int, k: int,
                       passing: int, w: int = PROGRAM_WIDTH) -> tuple[int, int]:
    """(FLOPs, bytes) of one pre-filtering ``filtered_topk`` call: B queries
    over N rows, ``passing`` the rows passing the queries' filters, summed
    over the queries.  Every row, norm and attribute, the queries and the
    programs read once, k ids and distances a query written once; a d-long
    dot for each passing pair only (a failing pair needs no distance)."""
    nbytes = (n * 4 * (d + 1 + mi + mf) + b * d * 4
              + program_bytes(b, w, mi, mf) + b * k * 8)
    return 2 * d * passing, nbytes


def pq_adc_topr_work(b: int, n: int, m: int, ksub: int, mi: int, mf: int,
                     r: int, passing: int,
                     w: int = PROGRAM_WIDTH) -> tuple[int, int]:
    """(operations, bytes) of one ``pq_adc_topr`` call (the compressed brute
    route's scan): B queries over N rows of ``m`` one-byte codes, ``passing``
    the rows passing the queries' filters, summed over the queries.  Every
    code row, norm and attribute, the (B, m, ksub) f32 tables and the
    programs read once, r candidates a query (id and distance) written
    once; one m-long lookup-add for each passing pair only."""
    nbytes = (n * (m + 4 * (1 + mi + mf)) + b * m * ksub * 4
              + program_bytes(b, w, mi, mf) + b * r * 8)
    return m * passing, nbytes


def traversal_pq_gather_work(b: int, rows: int, m: int, ksub: int, mi: int,
                             mf: int, lut_bytes: int, w: int = PROGRAM_WIDTH,
                             id_bytes: int = 8) -> tuple[int, int]:
    """(operations, bytes) of the ``pq_adc_gather`` work a graph traversal
    of ``b`` queries needs under ``graph_quant="pq"``, whatever blocks it is
    cut into: ``rows`` the neighbour rows it scores, each row's code row,
    attributes and id read once, its m table entries (``lut_bytes`` each)
    read, and its key and TD byte written once; the queries' D and programs
    read once; m adds a row.  The (B, m, ksub) tables are read at most
    whole: a query's lookups past its m x ksub entries repeat some."""
    dense = b * 4 + program_bytes(b, w, mi, mf)
    tables = lut_bytes * min(rows * m, b * m * ksub)
    scattered = rows * (m + 4 * (mi + mf) + id_bytes + 5)
    return rows * m, dense + tables + scattered


def bound_s(flops: float, nbytes: float, peaks: dict = PEAKS) -> float:
    """The least time the card could take: the larger of operations over
    the float32 peak and bytes over the memory bandwidth."""
    return max(flops / peaks["f32_flops"], nbytes / peaks["hbm_bytes_per_s"])
