"""Measurement tools of the port: scripts run on a CUDA card whose
numbers PERF.md quotes."""
