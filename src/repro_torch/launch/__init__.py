"""Launchers of the port: the training CLI (``python -m repro_torch.launch.train``)."""
