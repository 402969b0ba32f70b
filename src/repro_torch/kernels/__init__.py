"""Kernels of the port and their plain versions (kernels/distill_kl.py,
kernels/paged_attention.py, kernels/flash_attention.py,
kernels/ssd_scan.py), oracles
(kernels/ref.py), the CUDA C++ sources (kernels/csrc/) and their build
(kernels/cuda_build.py)."""


def counters() -> list:
    """Every launch and route counter of the port's kernels (one dict
    each, kernel name or route to launches). A wrapper adds to them on
    the host where it launches its kernel; ``core/graph.CapturedEpoch``
    adds a captured graph's recorded launches on each replay."""
    from repro_torch.kernels import distill_kl, flash_attention as FA
    from repro_torch.kernels import paged_attention as PA, ssd_scan as SS

    return [distill_kl.launches, FA.launches, FA.fwd_routes, FA.bwd_routes,
            FA.dq_routes, FA.dkv_routes, PA.launches, PA.routes,
            SS.launches, SS.fwd_routes, SS.bwd_routes]
