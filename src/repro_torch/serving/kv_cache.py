"""KV-cache placement policy for tensor-parallel serving.

Head-dimension sharding needs (kv_heads * repeat) % tp == 0 and
num_heads % (kv_heads * repeat) == 0.  When a repeat factor exists
(qwen3: 8 kv heads x2 -> 16 on a 16-way model axis) we physically
replicate each KV head ``repeat`` times at cache-write time — the
standard vLLM-style KV replication under TP; per-device bytes equal
ideal sharding.  When none exists (gemma3 kv=1 q=4, hymba kv=5,
whisper kv=20) the cache replicates over the model axis and shards
over batch — or over SEQUENCE for small-batch long-context shapes
(long_500k, batch 1), which is the sequence-parallel decode path.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    kv_repeat: int  # physical KV-head replication factor (1 = none)
    shard_heads: bool  # cache kv-head dim sharded over "model"
    shard_batch: bool  # cache batch dim sharded over the data axes
    seq_axes: tuple[str, ...]  # logical axes ("data"/"model") for the seq dim


def choose_cache_policy(cfg: ModelConfig, tp: int, batch: int, data: int) -> CachePolicy:
    """Pick the KV layout for a (model, mesh, shape) cell.

    Preference order for the big cache dims:
      1. heads over "model" (with physical KV replication if a factor
         exists), batch over "data";
      2. heads unshardable -> cache SEQUENCE over "model" (sequence-
         parallel decode: attention partial-sums psum over "model");
      3. batch too small for "data" (long-context, batch=1) -> sequence
         additionally takes the "data" axes.
    """
    shard_batch = batch >= data
    if cfg.attn_type == "mla":
        seq_axes = ("model",) if shard_batch else ("data", "model")
        return CachePolicy(1, False, shard_batch, seq_axes)
    if cfg.family == "ssm":
        return CachePolicy(1, False, shard_batch, ())
    for repeat in (1, 2, 4, 8, 16):
        kvh = cfg.num_kv_heads * repeat
        if kvh % tp == 0 and cfg.num_heads % kvh == 0:
            seq_axes = () if shard_batch else ("data",)
            return CachePolicy(repeat, True, shard_batch, seq_axes)
    seq_axes = ("model",) if shard_batch else ("data", "model")
    return CachePolicy(1, False, shard_batch, seq_axes)


def cache_bytes(cfg: ModelConfig, policy: CachePolicy, batch: int, seq: int, bytes_per=2) -> int:
    """Global cache bytes for capacity planning."""
    if cfg.family == "ssm":
        d = cfg.d_model
        mh = cfg.num_heads
        mhd = 2 * d // mh
        per = mh * mhd * mhd * 4 + mh * mhd * 4 + 4 * d * 4
        return cfg.num_layers * batch * per
    hd = cfg.resolved_head_dim
    if cfg.attn_type == "mla":
        per_tok = cfg.kv_lora_rank + cfg.rope_head_dim
    else:
        per_tok = 2 * cfg.num_kv_heads * policy.kv_repeat * hd
    total = cfg.num_layers * batch * seq * per_tok * bytes_per
    if cfg.family == "hybrid":
        d_in = 2 * cfg.d_model
        total += cfg.num_layers * batch * (d_in * cfg.ssm_state * 4 + (cfg.ssm_conv - 1) * d_in * bytes_per)
    return total
