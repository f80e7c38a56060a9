"""Data substrate: synthetic dataset generators standing in for the
paper's eight evaluation datasets.  The reference's sharded resumable
pipeline (``data/pipeline.py``) is not ported yet (ROADMAP.md, port
queue: 'LLM side stack')."""
