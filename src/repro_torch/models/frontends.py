"""Modality frontend stubs of the port: ``repro.models.frontends``.

The VLM and audio configurations specify the transformer backbone only;
their frontends are stubs that give precomputed patch or frame
embeddings.  The stubs fix the shape contract between frontend and
backbone, and draw synthetic embeddings so that the serving paths run end
to end without an image or audio encoder.  For the VLM, the number of
patch embeddings is a function of the input resolution: the planner's
resolution choice reaches the backbone through
:func:`num_patches_for_resolution`.

The reference draws its embeddings from a ``jax.random`` key; here they
come from an explicit ``torch.Generator`` on an explicit device, so the
numbers differ for the same seed (the tests hand both packages the same
numpy embeddings).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def num_patches_for_resolution(image_size: int, patch_size: int = 14, downsample: float = 0.5) -> int:
    """InternVL-style pixel-shuffle: (size/patch)^2 * downsample^2."""
    side = image_size // patch_size
    return max(1, int(side * side * downsample * downsample))


def audio_frames_for_seconds(seconds: float, frames_per_second: int = 50) -> int:
    """Whisper: 30 s -> 1500 frames after the conv frontend (2x downsample
    of 100 Hz mel frames)."""
    return int(seconds * frames_per_second)


def _normal(generator: torch.Generator, shape: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} but embeddings on {dev}")
    return torch.empty(shape, dtype=torch.float32, device=dev).normal_(generator=generator).to(dtype)


def vit_stub_embeddings(generator: torch.Generator, batch: int, num_patches: int, d_model: int,
                        dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Precomputed ViT patch embeddings (stand-in for InternViT-6B):
    (batch, num_patches, d_model), N(0, 1) drawn in f32 and cast."""
    return _normal(generator, (batch, num_patches, d_model), dtype, device)


def conv_stub_frames(generator: torch.Generator, batch: int, num_frames: int, d_model: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Precomputed conv-frontend frame embeddings (stand-in for Whisper's
    two Conv1d + GELU layers over 128-mel spectrograms): (batch,
    num_frames, d_model), N(0, 1) drawn in f32 and cast."""
    return _normal(generator, (batch, num_frames, d_model), dtype, device)
