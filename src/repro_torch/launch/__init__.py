"""Launch layer of the port: the training entry point (``python -m
repro_torch.launch.train``) and the serving entry point (``python -m
repro_torch.launch.serve``).  The reference's mesh construction, dry-run
and HLO analysis are specific to XLA and are not ported."""
