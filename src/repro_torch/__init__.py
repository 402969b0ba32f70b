"""DENSE (data-free one-shot federated learning) in PyTorch.

The port of the JAX package ``repro`` to PyTorch and CUDA. It mirrors
``repro``'s subpackages (configs, data, optim, models, kernels, core, fl)
and imports nothing of it. Entry points run on ``device="cuda"`` unless
the caller passes another device.
"""
