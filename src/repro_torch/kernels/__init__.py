"""Kernels of the port and their plain versions (kernels/distill_kl.py)
and oracles (kernels/ref.py)."""
