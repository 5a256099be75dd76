"""Benchmarks of the port: ``bench_kernels`` (the kernel-path bench)."""
