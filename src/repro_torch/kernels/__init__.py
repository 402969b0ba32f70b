"""Kernels of the port and their plain versions (kernels/distill_kl.py,
kernels/paged_attention.py, kernels/flash_attention.py,
kernels/ssd_scan.py), oracles
(kernels/ref.py), the CUDA C++ sources (kernels/csrc/) and their build
(kernels/cuda_build.py)."""
