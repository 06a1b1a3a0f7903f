"""Tools that run the port's kernels outside the checker's entry points.

- :mod:`.ablate_lane` — the lane-kernel ablation harness: variants of
  the returns walk's body as CUDA kernels (K6, K7), timed on the card.
"""
