"""Launch layer of the port: meshes (``launch/mesh.py``), the serving and
training CLIs (``launch/serve.py``, ``launch/train.py``), and the dry run
(``launch/dryrun.py`` over ``launch/specs.py``' cells and
``launch/hlo_analysis.py``' count of a traced program)."""
