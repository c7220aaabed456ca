"""Launchers of the port: the mesh of ranks (``mesh``) and the training
CLI (``train``: ``python -m repro_torch.launch.train simulate|distributed``)."""
