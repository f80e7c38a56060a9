"""Natively-present visual data formats — the paper's ℱ.

Image/video serving systems store multiple encodings of the same content
(full-resolution JPEG, 161-px thumbnails in PNG/JPEG, multi-bitrate video
renditions).  ``StoredImage`` / ``StoredVideo`` model exactly that: one
logical asset, several physical encodings, so SMOL's planner can treat the
*input format* as a plan dimension (§5.2).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.preprocessing import jpeg, png, video
from repro_torch.preprocessing.ops import ResizeShortSide


@dataclasses.dataclass(frozen=True)
class ImageFormat:
    # "jpeg" | "png" — the repo's own codecs with partial decoding (§6.4);
    # "pjpeg" — real libjpeg via Pillow.  The C decoder releases the GIL,
    # which is what lets the runtime's multi-worker host stage actually
    # scale decode throughput across producer threads (numpy-codec decode
    # serializes on the GIL).  Production analogue of the entropy stage.
    codec: str
    short_side: int | None = None  # None = native resolution
    quality: int | None = None  # jpeg only
    # jpeg only: store with 4:2:0 chroma subsampling (the overwhelmingly
    # common encoding in real corpora; the split-decode device program
    # handles it natively via ragged-chroma staging + device upsampling)
    subsample: bool = False

    @property
    def key(self) -> str:
        res = "full" if self.short_side is None else str(self.short_side)
        q = "" if self.quality is None else f"_q{self.quality}"
        sub = "_420" if self.subsample else ""
        return f"{self.codec}_{res}{q}{sub}"

    def __str__(self) -> str:
        return self.key


FULL_JPEG_Q95 = ImageFormat("jpeg", None, 95)
FULL_JPEG_Q75 = ImageFormat("jpeg", None, 75)
THUMB_PNG_161 = ImageFormat("png", 161, None)
THUMB_JPEG_161_Q95 = ImageFormat("jpeg", 161, 95)
THUMB_JPEG_161_Q75 = ImageFormat("jpeg", 161, 75)

# The format set evaluated in the paper's image experiments (§8.1).
PAPER_IMAGE_FORMATS = [
    FULL_JPEG_Q95,
    THUMB_PNG_161,
    THUMB_JPEG_161_Q95,
    THUMB_JPEG_161_Q75,
]


class StoredImage:
    """One logical image stored in several physical encodings.

    ``uid`` is the corpus-level identity of the logical asset (a stable
    key across repeat queries — think the database row id).  When set, the
    runtime's rendition cache may key materialized physical
    representations (staged coefficient tensors, transcoded pixel
    renditions) on it; ``None`` falls back to object identity, which the
    cache guards with a weakref finalizer.
    """

    def __init__(
        self,
        variants: dict[ImageFormat, bytes],
        native_shape: tuple[int, int, int],
        uid: int | str | None = None,
    ):
        self.variants = variants
        self.native_shape = native_shape
        self.uid = uid

    @classmethod
    def from_array(
        cls,
        img: np.ndarray,
        formats: list[ImageFormat] | None = None,
        uid: int | str | None = None,
    ) -> "StoredImage":
        formats = formats or PAPER_IMAGE_FORMATS
        variants: dict[ImageFormat, bytes] = {}
        for fmt in formats:
            src = img
            # pjpeg stores native resolution: its short_side is a *decode-time*
            # scaled-IDCT target (libjpeg draft), the paper's §6.4
            # multi-resolution partial decode, not a stored thumbnail.
            if (
                fmt.codec != "pjpeg"
                and fmt.short_side is not None
                and fmt.short_side < min(img.shape[:2])
            ):
                src = ResizeShortSide(fmt.short_side).apply_host(img)
            if fmt.codec == "jpeg":
                variants[fmt] = jpeg.encode(
                    src, quality=fmt.quality or 75, subsample=fmt.subsample
                )
            elif fmt.codec == "pjpeg":
                variants[fmt] = _pil_jpeg_encode(src, quality=fmt.quality or 75)
            elif fmt.codec == "png":
                variants[fmt] = png.encode(src)
            else:
                raise ValueError(f"unknown codec {fmt.codec}")
        return cls(variants, tuple(img.shape), uid=uid)

    def formats(self) -> list[ImageFormat]:
        return list(self.variants)

    def nbytes(self, fmt: ImageFormat) -> int:
        return len(self.variants[fmt])

    def decode(
        self,
        fmt: ImageFormat,
        roi: tuple[int, int, int, int] | None = None,
        max_rows: int | None = None,
        dc_only: bool = False,
    ) -> np.ndarray:
        data = self.variants[fmt]
        if fmt.codec == "jpeg":
            return jpeg.decode(data, roi=roi, max_rows=max_rows, dc_only=dc_only)
        if fmt.codec == "pjpeg":
            return _pil_jpeg_decode(
                data, roi=roi, max_rows=max_rows, dc_only=dc_only, short_side=fmt.short_side
            )
        if roi is not None or dc_only:
            # PNG-analog supports early stopping only (paper Table 4).
            out = png.decode(data, max_rows=None if roi is None else roi[2])
            if roi is not None:
                y0, x0, y1, x1 = roi
                return out[y0:y1, x0:x1]
            return out
        return png.decode(data, max_rows=max_rows)

    def decode_to_coefficients(self, fmt: ImageFormat, **kw):
        """Split-decode path (host entropy stage only) — JPEG variants only."""
        if fmt.codec != "jpeg":
            raise ValueError("split decode requires a JPEG variant")
        return jpeg.decode_to_coefficients(self.variants[fmt], **kw)


def _pil_jpeg_encode(img: np.ndarray, quality: int) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _pil_jpeg_decode(
    data: bytes,
    roi: tuple[int, int, int, int] | None = None,
    max_rows: int | None = None,
    dc_only: bool = False,
    short_side: int | None = None,
) -> np.ndarray:
    import io

    from PIL import Image

    im = Image.open(io.BytesIO(data))
    native_h = im.height
    if dc_only:
        # libjpeg's scaled IDCT decode: the real DC-only / progressive
        # first-scan fast path (mirrors jpeg.decode(dc_only=True))
        im.draft("RGB", (max(1, im.width // 8), max(1, im.height // 8)))
    elif short_side is not None:
        # multi-resolution partial decode (§6.4): entropy-decode the full
        # stream but run the IDCT at the 1/2^k scale that still covers the
        # target short side — draft never undershoots the requested size
        scale = max(1, min(im.width, im.height) // short_side)
        im.draft("RGB", (max(1, im.width // scale), max(1, im.height // scale)))
    out = np.asarray(im.convert("RGB"))
    # roi/max_rows arrive in native full-resolution coordinates (same
    # contract as jpeg.decode / planner.central_roi); map them onto the
    # post-draft grid before slicing
    s = out.shape[0] / native_h
    if roi is not None and not dc_only:
        y0, x0, y1, x1 = roi
        out = out[
            int(np.floor(y0 * s)) : int(np.ceil(y1 * s)),
            int(np.floor(x0 * s)) : int(np.ceil(x1 * s)),
        ]
    if max_rows is not None:
        out = out[: max(1, int(np.ceil(max_rows * s)))]
    return out


@dataclasses.dataclass(frozen=True)
class VideoFormat:
    codec: str = "svid"
    short_side: int | None = None  # None = native; 480 = the paper's low-res rendition
    quality: int = 75

    @property
    def key(self) -> str:
        res = "full" if self.short_side is None else f"{self.short_side}p"
        return f"{self.codec}_{res}_q{self.quality}"

    def __str__(self) -> str:
        return self.key


class StoredVideo:
    """One logical video stored at several renditions (YouTube-style)."""

    def __init__(self, variants: dict[VideoFormat, bytes], native_shape: tuple[int, ...]):
        self.variants = variants
        self.native_shape = native_shape

    @classmethod
    def from_frames(
        cls,
        frames: np.ndarray,
        formats: list[VideoFormat] | None = None,
        gop: int = 8,
    ) -> "StoredVideo":
        formats = formats or [VideoFormat(), VideoFormat(short_side=min(frames.shape[1:3]) // 2)]
        variants: dict[VideoFormat, bytes] = {}
        for fmt in formats:
            src = frames
            if fmt.short_side is not None and fmt.short_side < min(frames.shape[1:3]):
                rs = ResizeShortSide(fmt.short_side)
                src = np.stack([rs.apply_host(f) for f in frames])
            variants[fmt] = video.encode(src, quality=fmt.quality, gop=gop)
        return cls(variants, tuple(frames.shape))

    def formats(self) -> list[VideoFormat]:
        return list(self.variants)

    def nbytes(self, fmt: VideoFormat) -> int:
        return len(self.variants[fmt])

    def decode(
        self,
        fmt: VideoFormat,
        frame_indices: list[int] | None = None,
        max_frames: int | None = None,
        deblock: bool = True,
    ) -> np.ndarray:
        return video.decode(
            self.variants[fmt],
            frame_indices=frame_indices,
            max_frames=max_frames,
            deblock=deblock,
        )
