"""Scripts of the port, run as `python -m pytorch_glow_tpu_torch.scripts.<name>`:
on the card, the flow-step anatomy studies `perf_kernel_anatomy` (S1,
forward), `perf_reverse_anatomy` (S2) and `perf_bwd_anatomy` (S3), sharing
`_anatomy`, `perf_invconv`, the host and device time of the LU 1x1 conv
calls (and of each kernel through its `torch.library` op), and
`bench_serve`, the serving artifacts' images/s against the live model,
and `perf_multi`, training time on 1 to N cards under
`torch.distributed.run` (data, tensor and spatial parallelism) and SPMD
serving (`bench_serve`'s SPMD mode); on the CPU, the multi-rank drills
`multihost_smoke`, `multihost_preempt_smoke` and
`multihost_tfrecord_smoke` (gloo ranks, sharing `_smoke_common`);
anywhere, `run_summary`, a training run's step time and boundaries read
from its metrics.csv, `torch_migrate`, lineage snapshots to and from the
port's checkpoints, `prepare_tfrecords`, a dataset written as TFRecord
shards, `memory_report`, the device memory of a train step and a sample
(the byte counts alone with `--cpu`), `lr_probe`, the lr at which a
profile's training blows up, `vardeq_ab` and `vardeq_overhead_ab`,
uniform against variational dequantization (the bounds, the step's
cost), and `dress_rehearsal`, the whole data-to-serving chain through
the CLIs."""
