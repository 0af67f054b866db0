"""Product-quantization codebooks (k-means on the device) and the
scalar-quantization fallback.

PQ splits each d-dim vector into ``M`` contiguous subvectors of ``dsub``
dims (zero-padded when ``M`` does not divide ``d``) and learns one
K = 2^nbits centroid codebook per subspace with Lloyd's algorithm, batched
over subspaces.  A vector is stored as M uint8 codes (nbits <= 8): ``M``
bytes instead of ``4 * d``.

The scalar-quantization (SQ) fallback is per-dimension affine int8: 4x
compression, no training beyond a min/max pass.

Codebooks hold numpy arrays (host state, like ``HnswIndex``) and round-trip
through one ``.npz`` in the JAX package's layout (``save_codebook`` /
``load_codebook``).  ``train_pq``, ``encode`` and ``decode`` run in torch on
the device they are given; ``train_pq`` and ``encode`` of host data default
to the CUDA device (``device="cpu"`` runs them on the host).  torch's
generator cannot reproduce ``jax.random.choice``, so the port's k-means
starts from other centroids than the JAX package's and is held to it on
recall, not on bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..kernels._common import no_tf32


@dataclass
class PQCodebook:
    """Per-subspace centroid tables.

    centroids : (M, K, dsub) float32
    dim       : original vector dimensionality (<= M * dsub; the tail of the
                last subspace is zero padding)
    """

    centroids: np.ndarray
    dim: int

    @property
    def m(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def ksub(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def dsub(self) -> int:
        return int(self.centroids.shape[2])

    @property
    def nbits(self) -> int:
        return int(round(float(np.log2(self.ksub))))

    @property
    def padded_dim(self) -> int:
        return self.m * self.dsub

    def bytes_per_vector(self) -> int:
        return self.m  # one uint8 code per subspace (nbits <= 8)


@dataclass
class SQCodebook:
    """Per-dimension affine int8 quantizer: x ~= code * scale + lo."""

    lo: np.ndarray     # (d,) float32
    scale: np.ndarray  # (d,) float32
    dim: int

    def bytes_per_vector(self) -> int:
        return self.dim  # one uint8 code per dimension

    @property
    def padded_dim(self) -> int:
        return self.dim


def _pad_split(x: torch.Tensor, m: int, dsub: int) -> torch.Tensor:
    """(N, d) -> (N, m, dsub) with zero padding on the feature tail."""
    n, d = x.shape
    pad = m * dsub - d
    if pad:
        x = torch.cat([x, x.new_zeros((n, pad))], dim=1)
    return x.reshape(n, m, dsub)


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)
                           if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# k-means, batched over subspaces
# ---------------------------------------------------------------------------
def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(S, n, dsub), (S, k, dsub) -> (S, n) nearest-centroid ids (squared
    L2, the JAX package's |x|^2 - 2 x.c + |c|^2; first index on ties)."""
    d2 = ((x * x).sum(dim=-1)[:, :, None]
          - 2.0 * torch.bmm(x, c.transpose(1, 2))
          + (c * c).sum(dim=-1)[:, None, :])
    return torch.argmin(d2, dim=2)


def _lloyd_step(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration over S subspaces at once.  The centroid sums are
    a one-hot product, as in the JAX package, so they do not depend on the
    order of atomic adds; empty clusters keep their centroid."""
    s, n, k = c.shape[0], x.shape[1], c.shape[1]
    oh = torch.zeros((s, n, k), dtype=torch.float32, device=x.device)
    oh.scatter_(2, _assign(x, c)[:, :, None], 1.0)
    cnt = oh.sum(dim=1)                                   # (S, k)
    sums = torch.bmm(oh.transpose(1, 2), x)               # (S, k, dsub)
    return torch.where(cnt[:, :, None] > 0,
                       sums / cnt.clamp(min=1.0)[:, :, None], c)


def train_pq(vectors, m: int = 8, nbits: int = 8, *, iters: int = 20,
             sample: int = 65536, seed: int = 0, device=None) -> PQCodebook:
    """Train an M x 2^nbits PQ codebook on (a sample of) the dataset, on
    ``device`` (None: the CUDA device, which raises without a card).  The
    sample rows are drawn as the JAX package draws them (numpy, ``seed``);
    each subspace starts from K distinct sample rows picked by a
    ``torch.Generator`` seeded with ``seed``."""
    if not 1 <= nbits <= 8:
        raise ValueError("codes are uint8: nbits must be in [1, 8]")
    dev = resolve_device(device)
    no_tf32(dev)
    vectors = np.asarray(vectors.cpu() if isinstance(vectors, torch.Tensor)
                         else vectors, np.float32)
    n, d = vectors.shape
    k = 1 << nbits
    rng = np.random.default_rng(seed)
    if n > sample:
        vectors = vectors[rng.choice(n, size=sample, replace=False)]
        n = sample
    if n < k:
        raise ValueError(f"need >= {k} training vectors for 2^{nbits} "
                         f"centroids, got {n}")
    dsub = -(-d // m)
    xs = _pad_split(_as_f32(vectors, dev), m, dsub).transpose(0, 1)
    xs = xs.contiguous()                                   # (m, n, dsub)
    gen = torch.Generator(device=dev).manual_seed(seed)
    init = torch.rand((m, n), generator=gen, device=dev).argsort(dim=1)[:, :k]
    cents = torch.gather(xs, 1, init[:, :, None].expand(m, k, dsub))
    # subspaces in groups, so the (group, n, k) distance block stays small
    group = max(1, min(m, (1 << 22) // max(1, n * k)))
    for s in range(0, m, group):
        x, c = xs[s:s + group], cents[s:s + group]
        for _ in range(iters):
            c = _lloyd_step(c, x)
        cents[s:s + group] = c
    return PQCodebook(cents.cpu().numpy().astype(np.float32), dim=d)


def train_sq(vectors) -> SQCodebook:
    """Per-dimension affine int8 quantizer from a min/max pass."""
    vectors = np.asarray(vectors.cpu() if isinstance(vectors, torch.Tensor)
                         else vectors, np.float32)
    lo = vectors.min(axis=0)
    hi = vectors.max(axis=0)
    scale = np.maximum((hi - lo) / 255.0, 1e-12).astype(np.float32)
    return SQCodebook(lo.astype(np.float32), scale, dim=vectors.shape[1])


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------
def encode(cb: PQCodebook | SQCodebook, vectors, chunk: int = 65536, *,
           device=None) -> torch.Tensor:
    """Vectors (N, d) -> uint8 codes on ``device`` (default: a tensor's own
    device; for numpy input the CUDA device, which raises without a card):
    (N, M) for PQ, (N, d) for SQ."""
    if device is None and isinstance(vectors, torch.Tensor):
        device = vectors.device
    dev = resolve_device(device)
    x = _as_f32(vectors, dev)
    if isinstance(cb, SQCodebook):
        lo = torch.as_tensor(cb.lo, device=dev)
        scale = torch.as_tensor(cb.scale, device=dev)
        q = torch.round((x - lo[None, :]) / scale[None, :])   # half to even
        return q.clamp(0, 255).to(torch.uint8)
    no_tf32(dev)
    cents = torch.as_tensor(cb.centroids, device=dev)
    out = torch.empty((x.shape[0], cb.m), dtype=torch.uint8, device=dev)
    for s in range(0, x.shape[0], chunk):
        xs = _pad_split(x[s:s + chunk], cb.m, cb.dsub).transpose(0, 1)
        out[s:s + chunk] = _assign(xs.contiguous(), cents).T.to(torch.uint8)
    return out


def decode(cb: PQCodebook | SQCodebook, codes) -> torch.Tensor:
    """Codes -> approximate float32 vectors (N, dim), on the codes'
    device."""
    codes = torch.as_tensor(codes)
    dev = codes.device
    if isinstance(cb, SQCodebook):
        return (codes.to(torch.float32) * torch.as_tensor(cb.scale, device=dev)
                + torch.as_tensor(cb.lo, device=dev))
    cents = torch.as_tensor(cb.centroids, device=dev)
    recon = cents[torch.arange(cb.m, device=dev)[None, :], codes.long()]
    return recon.reshape(codes.shape[0], cb.padded_dim)[:, :cb.dim].clone()


# ---------------------------------------------------------------------------
# persistence (the JAX package's .npz layout)
# ---------------------------------------------------------------------------
def save_codebook(path: str, cb: PQCodebook | SQCodebook) -> None:
    if isinstance(cb, PQCodebook):
        np.savez_compressed(path, kind="pq", centroids=cb.centroids,
                            dim=np.int64(cb.dim))
    else:
        np.savez_compressed(path, kind="sq", lo=cb.lo, scale=cb.scale,
                            dim=np.int64(cb.dim))


def load_codebook(path: str) -> PQCodebook | SQCodebook:
    with np.load(path) as z:
        kind = str(z["kind"])
        if kind == "pq":
            return PQCodebook(z["centroids"].astype(np.float32), int(z["dim"]))
        if kind == "sq":
            return SQCodebook(z["lo"].astype(np.float32),
                              z["scale"].astype(np.float32), int(z["dim"]))
    raise ValueError(f"unknown codebook kind {kind!r}")
