from repro_torch.kernels.fused_preproc.ops import (  # noqa: F401
    fused_resize_affine,
    fused_resize_normalize,
    resize_affine_planar,
)
