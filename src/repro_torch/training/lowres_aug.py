"""Low-resolution-augmented training (paper §5.3).

"SMOL trains DNNs to be aware of low-resolution by augmenting the input
data at training time: downsample the full-resolution inputs to the
desired resolution and then upsample them to the DNN input resolution",
deliberately baking resampling artifacts into training so accuracy
recovers on natively low-resolution serving data (paper Table 7).

Also models the *lossy* variant: round-tripping the downsampled image
through JPEG at a chosen quality, which is what a q=75 thumbnail actually
looks like at inference time.
"""

from __future__ import annotations

import numpy as np

from repro_torch.preprocessing import jpeg
from repro_torch.preprocessing.ops import Resize, ResizeShortSide


def lowres_augment(
    img: np.ndarray,  # (H, W, C) uint8 full-resolution training image
    short_side: int,  # the native thumbnail resolution (paper: 161)
    out_size: int,  # the DNN input resolution (paper: 224)
    jpeg_quality: int | None = None,  # None = lossless (PNG-analog) path
) -> np.ndarray:
    """Down -> (optional lossy round-trip) -> up.  Returns (out, out, C) uint8."""
    down = ResizeShortSide(short_side).apply_host(img)
    if jpeg_quality is not None:
        down = jpeg.decode(jpeg.encode(down, quality=jpeg_quality))
    return Resize(out_size, out_size).apply_host(down)


def augment_batch(
    batch: np.ndarray,  # (N, H, W, C) uint8
    short_side: int,
    out_size: int,
    jpeg_quality: int | None = None,
    prob: float = 1.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Apply low-res augmentation to a batch (optionally stochastically,
    keeping some full-resolution examples — 'in addition to standard data
    augmentation')."""
    rng = rng or np.random.default_rng(0)
    out = np.empty((batch.shape[0], out_size, out_size, batch.shape[3]), np.uint8)
    for i, img in enumerate(batch):
        if rng.random() < prob:
            out[i] = lowres_augment(img, short_side, out_size, jpeg_quality)
        else:
            out[i] = Resize(out_size, out_size).apply_host(img)
    return out
