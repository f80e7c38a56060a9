from repro_torch.kernels.decode_attention.ops import decode_attention_cache  # noqa: F401
