"""Per-pair and per-body operators of the step."""
