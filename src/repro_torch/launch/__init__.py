"""Launch layer of the port: the serving CLI (``launch/serve.py``)."""
