"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden=16, sym normalization."""
from ..models.gnn import GCNConfig
from .base import ArchSpec, GNN_CELLS


def spec() -> ArchSpec:
    cfg = GCNConfig(name="gcn-cora", n_layers=2, d_feat=1433, d_hidden=16,
                    n_classes=7, norm="sym")
    red = GCNConfig(name="gcn-red", n_layers=2, d_feat=32, d_hidden=16,
                    n_classes=7, norm="sym")
    return ArchSpec("gcn-cora", "gnn", "arXiv:1609.02907; paper", cfg, red,
                    GNN_CELLS,
                    notes="d_feat/n_classes follow each cell's dataset: "
                          "cora 1433/7, ogb_products 100/47, molecule 32/2")
