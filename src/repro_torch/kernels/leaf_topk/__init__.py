"""The compact engine's candidate pass: per (query, survivor leaf) the kk
smallest distances and their row ids."""
