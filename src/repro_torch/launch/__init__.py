"""Launch layer of the port: the training entry point (``python -m
repro_torch.launch.train``), the serving entry point (``python -m
repro_torch.launch.serve``) and the named meshes and sharding rules
(``mesh.py``, the plain-data half of the reference's).  The reference's
production mesh, dry-run and HLO analysis are specific to XLA and are not
ported."""
