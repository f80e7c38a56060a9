"""Training substrate: low-res-augmented training (paper §5.3), and the
LM trainer — AdamW and its schedule (``optimizer.py``), the loss, train
step and loop (``train_loop.py``)."""
