"""Tools that run the port's kernels outside the checker's entry points.

- :mod:`.ablate_lane` — the lane-kernel ablation harness: variants of
  the returns walk's body as CUDA kernels (K6, K7), timed on the card.
- :mod:`.walk_split` — where an invalid check spends its walk, stage by
  stage, and K1's and K2's times by CUDA events.
- :mod:`.table_times` — the table walks' times (K1, K2, K4, K5) by CUDA
  events, on one checkout's kernels, so that two trees compare in one
  call.
"""
