"""Per-layer metric readers: metrics/<metric name>.py, each with
read(ctx) -> float or None (nothing to read: the metric is left out of the
line).  ctx is harness/runner._trace_context's: spans, requests, work
(proofs or verifies), latencies, busy_s, window_s, kernels (device seconds
by kernel name), msm_digits, gpu (nvidia-smi's reading)."""
