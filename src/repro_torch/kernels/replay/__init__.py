"""The exact cascade replay over per-leaf top-k summaries."""
