"""Serving substrate of the port: the byte-level tokenizer and the batched
slot engine over ``models/decode.py``."""
