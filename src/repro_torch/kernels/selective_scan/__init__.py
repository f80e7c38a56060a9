from repro_torch.kernels.selective_scan.ops import selective_scan  # noqa: F401
