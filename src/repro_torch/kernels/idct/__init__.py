from repro_torch.kernels.idct.ops import SCALED_POINTS, dequant_idct, idct_rows  # noqa: F401
