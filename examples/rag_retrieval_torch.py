"""RAG-flavored example on PyTorch: LM embeddings + FAVOR filtered retrieval,
the counterpart of ``examples/rag_retrieval.py`` for the port.

A reduced LM (gemma2-2b's reduced config, random weights from a seed)
produces passage embeddings (the normalized mean of the passage's token
embeddings); FAVOR indexes them with per-passage metadata (source, recency,
length) and answers "retrieve top-k passages semantically close to the
query, but only from source X and newer than T" -- the hybrid-query
workload of the paper's introduction.  Everything runs on ``--device`` (the
CUDA card by default).

    PYTHONPATH=src python examples/rag_retrieval_torch.py
    PYTHONPATH=src python examples/rag_retrieval_torch.py --device cpu --n 1000
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_spec
from repro_torch.core import (BuildSpec, ColumnSpec, FavorIndex, HnswParams,
                              Schema, SearchOptions)
from repro_torch.core import filters as F
from repro_torch.core.filters import AttributeTable
from repro_torch.data import synthetic
from repro_torch.device import resolve_device, to_host
from repro_torch.models.transformer import LanguageModel


def embed_passages(lm: LanguageModel, tokens) -> np.ndarray:
    """The normalized mean of each passage's token embeddings: a cheap
    encoder over the LM's embedding table."""
    h = lm.embed[tokens].mean(dim=1)
    return to_host(h / torch.linalg.norm(h, dim=-1, keepdim=True))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n", type=int, default=4000, help="passages")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_spec("gemma2-2b").reduced
    lm = LanguageModel(cfg, seed=0, device=dev)

    n_passages = args.n
    pipe = synthetic.TokenPipeline(vocab=cfg.vocab, seq_len=32,
                                   batch=n_passages, seed=5)
    batch, _ = pipe(0)
    embs = embed_passages(lm, torch.as_tensor(batch["tokens"], device=dev))

    # metadata: source in {0..4}, age_days in [0, 365], length float
    schema = Schema((ColumnSpec("source", "int", 5),
                     ColumnSpec("age_days", "float"),
                     ColumnSpec("length", "float")))
    rng = np.random.default_rng(1)
    attrs = AttributeTable(
        schema,
        rng.integers(0, 5, size=(n_passages, 1)).astype(np.int32),
        np.stack([rng.uniform(0, 365, n_passages),
                  rng.uniform(50, 500, n_passages)], axis=1).astype(np.float32))

    fi = FavorIndex.build(embs, attrs,
                          spec=BuildSpec(hnsw=HnswParams(M=12, efc=60,
                                                         seed=2)),
                          device=dev)
    print(f"indexed {n_passages} passages on {fi.device}; "
          f"Delta_d={fi.delta_d:.4f}")

    qbatch, _ = pipe(1)
    q_embs = embed_passages(
        lm, torch.as_tensor(qbatch["tokens"][:8], device=dev))
    flt = F.And(F.Inclusion("source", [1, 3]),       # trusted sources only
                F.Range("age_days", None, 90.0))     # fresh (< 90 days)
    res = fi.query(q_embs, flt, SearchOptions(k=5, ef=64))
    print(f"p_hat={res.p_hat[0]:.3f} route="
          f"{'brute' if res.routed_brute[0] else 'graph'}")
    for i in range(4):
        got = res.ids[i][res.ids[i] >= 0]
        srcs = attrs.ints[got, 0].tolist()
        ages = attrs.floats[got, 0].round(0).tolist()
        print(f"  query {i}: passages={got.tolist()} sources={srcs} ages={ages}")
    ok = all(s in (1, 3) for i in range(len(res.ids))
             for s in attrs.ints[res.ids[i][res.ids[i] >= 0], 0].tolist())
    ok = ok and all(a <= 90.0 for i in range(len(res.ids))
                    for a in attrs.floats[res.ids[i][res.ids[i] >= 0], 0])
    if not ok:
        raise RuntimeError("a retrieved passage fails the metadata filter")
    print("all retrieved passages satisfy the metadata filter")
    return {"ids": res.ids, "found": int((res.ids >= 0).sum())}


if __name__ == "__main__":
    main()
