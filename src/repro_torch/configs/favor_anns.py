"""favor-anns: the paper's own system at production scale -- 64M vectors x
128 dims (16 shards of 4M rows in the JAX package's sharded layout), serve
batch 1024, PQ m=32 x 8-bit codes with an exact re-rank of 8k candidates.

The port's copy of the JAX package's ``repro.configs.favor_anns``: the
same fields, and helpers that build the port's ``QuantSpec`` /
``BuildSpec`` / ``SearchOptions``."""
from dataclasses import dataclass

from .base import ArchSpec, ShapeCell


@dataclass(frozen=True)
class FavorServeConfig:
    name: str = "favor-anns"
    n: int = 64_000_000
    dim: int = 128
    m_i: int = 2          # bool + int attribute columns
    m_f: int = 1
    k: int = 10
    ef: int = 128
    m0: int = 32
    m: int = 16
    n_upper: int = 3
    width: int = 8
    batch: int = 1024
    # compressed brute path (quant subsystem): 32 x uint8 PQ codes per
    # 128-dim vector = 16x fewer bytes streamed by the PreFBF scan, on both
    # the local backend and the sharded serve path (codes sharded on "model",
    # per-shard ADC scan + exact re-rank before the top-k merge).
    quantize: str | None = "pq"
    pq_m: int = 32
    pq_nbits: int = 8
    rerank: int = 8

    def quant_spec(self):
        """QuantSpec realizing this config's compressed memory format."""
        if self.quantize is None:
            return None
        from ..core.options import QuantSpec
        return QuantSpec(kind=self.quantize, m=self.pq_m, nbits=self.pq_nbits,
                         rerank=self.rerank)

    def build_spec(self, hnsw=None, quant="config", **overrides):
        """BuildSpec for FavorIndex.build / ShardedBackend.build; pass
        quant=None (or a QuantSpec) to override this config's format."""
        from ..core.options import BuildSpec
        if quant == "config":
            quant = self.quant_spec()
        return BuildSpec(hnsw=hnsw, quant=quant, **overrides)

    def search_options(self, **overrides):
        """SearchOptions matching this config's serve shape."""
        from ..core.options import SearchOptions
        kw = {"k": self.k, "ef": self.ef, "use_pq": self.quantize is not None}
        kw.update(overrides)
        return SearchOptions(**kw)

    def quant_kwargs(self) -> dict:
        """Deprecated: legacy FavorIndex(**kwargs) blob; use build_spec()."""
        import warnings
        warnings.warn("FavorServeConfig.quant_kwargs() is deprecated; use "
                      "build_spec()/quant_spec()", DeprecationWarning,
                      stacklevel=2)
        if self.quantize is None:
            return {}
        return {"quantize": self.quantize, "pq_m": self.pq_m,
                "pq_nbits": self.pq_nbits, "rerank": self.rerank}


def spec() -> ArchSpec:
    cfg = FavorServeConfig()
    red = FavorServeConfig(name="favor-red", n=4096, dim=16, batch=16, ef=48)
    cells = (
        ShapeCell("serve_graph", "favor_serve", {"route": "graph"}),
        ShapeCell("serve_brute", "favor_serve", {"route": "brute"}),
    )
    return ArchSpec("favor-anns", "favor", "this paper", cfg, red, cells)
