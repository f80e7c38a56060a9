"""Visual-data preprocessing substrate (port of ``repro.preprocessing``).

The SJPG/SPNG codecs, scratch buffers and formats are numpy copies of the
reference; ``ops`` pairs each operator's numpy host half with a torch
device half.  Submodules are imported lazily by users (``from
repro_torch.preprocessing import jpeg``) to keep import costs low and
avoid cycles.
"""
