"""Serving substrate of the port: the byte-level tokenizer, the batched
slot engine over ``models/decode.py``, and the KV-cache placement policy
(``serving/kv_cache.py``)."""
