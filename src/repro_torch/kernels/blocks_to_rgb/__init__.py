from repro_torch.kernels.blocks_to_rgb.ops import BlockGrid, blocks_to_rgb  # noqa: F401
