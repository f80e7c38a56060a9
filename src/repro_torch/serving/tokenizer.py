"""Self-contained byte-level tokenizer (no external vocab files).

Bytes 0..255 map to ids 3..258; specials: 0=pad, 1=bos, 2=eos.  Models
with larger vocabs simply don't use the tail ids.  Deliberately does
nontrivial host work per request (utf-8 validation + byte mapping) so the
serving engine's host/device pipelining has a real host stage to overlap.
"""

from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 0, 1, 2
OFFSET = 3
VOCAB = 256 + OFFSET


def encode(text: str, add_bos: bool = True) -> np.ndarray:
    b = np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32) + OFFSET
    if add_bos:
        b = np.concatenate([[BOS], b])
    return b.astype(np.int32)


def decode(ids: np.ndarray) -> str:
    ids = np.asarray(ids)
    ids = ids[(ids >= OFFSET) & (ids < VOCAB)]
    return (ids - OFFSET).astype(np.uint8).tobytes().decode("utf-8", errors="replace")


def encode_batch(texts: list[str], seq_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Left-aligned, padded batch.  Returns (tokens (B, seq_len), lengths)."""
    out = np.full((len(texts), seq_len), PAD, np.int32)
    lens = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        ids = encode(t)[:seq_len]
        out[i, : len(ids)] = ids
        lens[i] = len(ids)
    return out, lens
