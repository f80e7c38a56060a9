"""Data substrate: synthetic dataset generators standing in for the
paper's eight evaluation datasets (``datasets.py``), and the reference's
sharded, resumable LM input pipeline with prefetch (``pipeline.py``)."""
