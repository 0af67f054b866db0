"""The cell's data, made on the device from the seed in a few large calls.

A copy, in plain torch, of the port's synthetic generator
(``repro_torch/data/synthetic.py``): Gaussian-mixture vectors (``n_clusters``
centres drawn from N(0, 1), each row a centre plus ``cluster_std`` N(0, 1)
noise) and the paper's section 6.1.2 attributes (bool equiprobable, int
uniform over its vocabulary, float uniform over [0, 100)).  Queries come
from the same mixture: the same centres, fresh assignments and noise.  The
draws are torch's, not numpy's, so the bits differ from the port's
generator for the same seed; the distributions are the same.
"""
from __future__ import annotations

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one independent stream of the seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def schema_columns(cfg: dict) -> tuple[list, list]:
    """(int columns, float columns) of the configuration's schema, each a
    list of (name, kind, vocab) in the order the attribute tables hold
    them: bool and int columns in ``ints``, float columns in ``floats``."""
    ints = [(c["name"], c["kind"], 2 if c["kind"] == "bool" else c["vocab"])
            for c in cfg["schema"] if c["kind"] in ("bool", "int")]
    floats = [(c["name"], c["kind"], None)
              for c in cfg["schema"] if c["kind"] == "float"]
    return ints, floats


def make_base(cfg: dict, seed: int, device) -> dict:
    """The indexed rows: ``vectors`` (N, d) f32, ``ints`` (N, m_i) int32,
    ``floats`` (N, m_f) f32, and the mixture's ``centers``."""
    n, d, c = cfg["n"], cfg["dim"], cfg["n_clusters"]
    g = generator(seed, device, 0)
    centers = torch.randn((c, d), generator=g, device=device)
    assign = torch.randint(0, c, (n,), generator=g, device=device)
    vectors = torch.randn((n, d), generator=g, device=device)
    vectors.mul_(cfg["cluster_std"]).add_(centers[assign])
    del assign
    icols, fcols = schema_columns(cfg)
    ints = torch.empty((n, len(icols)), dtype=torch.int32, device=device)
    for j, (_, _, vocab) in enumerate(icols):
        ints[:, j] = torch.randint(0, vocab, (n,), generator=g, device=device,
                                   dtype=torch.int32)
    floats = torch.rand((n, len(fcols)), generator=g, device=device)
    floats.mul_(100.0)
    return {"vectors": vectors, "ints": ints, "floats": floats,
            "centers": centers}


def make_queries(cfg: dict, centers: torch.Tensor, count: int, seed: int,
                 device) -> torch.Tensor:
    """``count`` queries (count, d) f32 from the base rows' mixture."""
    g = generator(seed, device, 1)
    assign = torch.randint(0, centers.shape[0], (count,), generator=g,
                           device=device)
    q = torch.randn((count, cfg["dim"]), generator=g, device=device)
    return q.mul_(cfg["cluster_std"]).add_(centers[assign])
