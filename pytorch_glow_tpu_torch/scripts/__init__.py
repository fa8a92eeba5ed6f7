"""Measurement scripts of the port, run as `python -m
pytorch_glow_tpu_torch.scripts.<name>`: on the card, the flow-step
anatomy studies `perf_kernel_anatomy` (S1, forward),
`perf_reverse_anatomy` (S2) and `perf_bwd_anatomy` (S3), sharing
`_anatomy`, and `perf_invconv`, the host and device time of the LU 1x1
conv calls; anywhere, `run_summary`, a training run's step time and
boundaries read from its metrics.csv."""
