"""The 2-block LSTM filter backbone (the paper's Table 1 ablation)."""
