"""Synthetic stand-ins for the paper's eight evaluation datasets.

Image datasets (paper Table 6): bike-bird (2 classes), animals-10 (10),
birds-200 (200), imagenet (1000).  Video datasets (BlazeIt's): night-
street, taipei, amsterdam, rialto — aggregation queries over object
counts.

The generators are built so the paper's *phenomena* reproduce:

* images carry class signal at two spatial scales — a coarse color/layout
  component that survives downsampling and a FINE texture component that
  does not — so accuracy genuinely degrades on low-resolution inputs and
  low-res-augmented training genuinely recovers part of it (Table 7);
* harder datasets put more of the signal into the fine component
  (bike-bird easiest ... imagenet-sim hardest), reproducing the
  task-difficulty ordering of Figures 4-6;
* videos contain a Poisson-distributed number of moving objects per
  frame; the aggregation ground truth is the per-frame count (Figure 9).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.preprocessing.formats import PAPER_IMAGE_FORMATS, StoredImage, StoredVideo, VideoFormat


@dataclasses.dataclass(frozen=True)
class ImageDatasetSpec:
    name: str
    num_classes: int
    fine_fraction: float  # share of class signal living in fine texture
    native_size: int  # short side of "full resolution" images


IMAGE_DATASETS = {
    "bike-bird": ImageDatasetSpec("bike-bird", 2, 0.15, 256),
    "animals-10": ImageDatasetSpec("animals-10", 10, 0.3, 256),
    "birds-200": ImageDatasetSpec("birds-200", 200, 0.5, 288),
    "imagenet-sim": ImageDatasetSpec("imagenet-sim", 1000, 0.6, 256),
}

VIDEO_DATASETS = ["night-street", "taipei", "amsterdam", "rialto"]


def make_image(spec: ImageDatasetSpec, label: int, rng: np.random.Generator) -> np.ndarray:
    """One (H, W, 3) uint8 image whose class is decodable from a coarse
    palette/layout component plus a fine high-frequency texture."""
    h = w = spec.native_size
    cls_rng = np.random.default_rng(label)  # class-deterministic signature

    # coarse: class-specific 4x4 color layout, upsampled
    layout = cls_rng.uniform(0.2, 0.8, size=(4, 4, 3))
    coarse = np.kron(layout, np.ones((h // 4, w // 4, 1)))

    # fine: class-specific oriented grating, 4..8 px period
    fy, fx = cls_rng.uniform(0.4, 1.0, 2) * 2 * np.pi / 6
    phase = cls_rng.uniform(0, 2 * np.pi)
    yy, xx = np.mgrid[0:h, 0:w]
    grating = 0.5 + 0.5 * np.sin(fy * yy + fx * xx + phase)
    fine = grating[..., None] * cls_rng.uniform(0.3, 1.0, size=(1, 1, 3))

    alpha = spec.fine_fraction
    img = (1 - alpha) * coarse + alpha * fine
    img = img + rng.normal(0, 0.08, size=img.shape)  # instance noise
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def image_dataset(
    name: str, n: int, seed: int = 0, formats=None
) -> tuple[list[StoredImage], np.ndarray]:
    """n stored images (all paper formats) + labels."""
    spec = IMAGE_DATASETS[name]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, spec.num_classes, size=n)
    stored = [
        StoredImage.from_array(make_image(spec, int(y), rng), formats or PAPER_IMAGE_FORMATS)
        for y in labels
    ]
    return stored, labels


def raw_image_batch(name: str, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Uncompressed images (for training) + labels."""
    spec = IMAGE_DATASETS[name]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, spec.num_classes, size=n)
    imgs = np.stack([make_image(spec, int(y), rng) for y in labels])
    return imgs, labels


def make_video(
    name: str, num_frames: int, seed: int = 0, size: int = 96, mean_objects: float = 2.0
) -> tuple[np.ndarray, np.ndarray]:
    """(T, H, W, 3) uint8 frames + per-frame object counts.

    Objects are bright moving blobs on a static background; the per-frame
    ground truth count is what BlazeIt-style aggregation estimates."""
    # as the reference: Python salts str hashes per process, so these frames
    # are reproducible (and equal to the reference's) within one process only
    rng = np.random.default_rng((hash(name) & 0xFFFF, seed))
    h = w = size
    bg = rng.uniform(0.1, 0.4, size=(h, w, 3))
    bg = np.kron(
        rng.uniform(0.1, 0.5, size=(8, 8, 3)), np.ones((h // 8, w // 8, 1))
    ) * 0.5 + bg * 0.5

    max_obj = 8
    counts = np.minimum(rng.poisson(mean_objects, size=num_frames), max_obj)
    frames = np.empty((num_frames, h, w, 3), np.uint8)
    # persistent tracks
    pos = rng.uniform(10, size - 10, size=(max_obj, 2))
    vel = rng.uniform(-2, 2, size=(max_obj, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    for t in range(num_frames):
        img = bg.copy()
        pos = pos + vel
        pos = np.clip(pos, 6, size - 6)
        for o in range(counts[t]):
            d2 = (yy - pos[o, 0]) ** 2 + (xx - pos[o, 1]) ** 2
            blob = np.exp(-d2 / 18.0)
            img += blob[..., None] * np.array([0.9, 0.8, 0.3])
        img += rng.normal(0, 0.02, size=img.shape)
        frames[t] = np.clip(img * 255, 0, 255).astype(np.uint8)
    return frames, counts.astype(np.int64)


def video_dataset(
    name: str, num_frames: int, seed: int = 0, size: int = 96
) -> tuple[StoredVideo, np.ndarray]:
    frames, counts = make_video(name, num_frames, seed, size)
    stored = StoredVideo.from_frames(
        frames, formats=[VideoFormat(), VideoFormat(short_side=size // 2)]
    )
    return stored, counts
