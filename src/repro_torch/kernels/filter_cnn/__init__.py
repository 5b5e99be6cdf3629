"""The 2-layer CNN filter backbone (the paper's Table 1 ablation)."""
