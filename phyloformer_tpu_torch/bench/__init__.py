"""Benchmarks of the port: the accuracy grid (``pf-bench-torch
accuracy-grid``) and synthetic throughput (``pf-bench-torch throughput``)."""
