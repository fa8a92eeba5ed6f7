"""Measurement scripts of the port, run on the card as `python -m
pytorch_glow_tpu_torch.scripts.<name>`: the flow-step anatomy studies
`perf_kernel_anatomy` (S1, forward), `perf_reverse_anatomy` (S2) and
`perf_bwd_anatomy` (S3), sharing `_anatomy`."""
