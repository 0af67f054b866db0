"""NVIDIA H100 SXM5 constants (one card), from NVIDIA's public H100 Tensor
Core GPU data sheet, SXM5 column, at its full 700 W power limit."""

# data sheet: "BF16 Tensor Core 1,979 teraFLOPS*", * with sparsity: the
# dense rate is half of it
PEAK_FLOPS_BF16 = 989.4e12    # per card, bf16 dense
# data sheet: "GPU memory bandwidth 3.35TB/s"
HBM_BW = 3.35e12              # bytes/s per card
# data sheet: "GPU memory 80GB"
HBM_PER_CHIP = 80e9
# data sheet: "NVLink: 900GB/s" over the card's 18 NVLink-4 links, both
# directions together: 50 GB/s a link (the rate the collective term
# charges, as the JAX package charged one ICI link's)
NVLINK_LINK_BW = 900e9 / 18   # bytes/s per link

# the dry run's production meshes (``launch/mesh.py``): device counts, not
# rates
CHIPS_SINGLE_POD = 256
CHIPS_MULTI_POD = 512
