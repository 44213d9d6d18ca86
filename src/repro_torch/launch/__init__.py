"""Launchers of the port: the serving launcher (``repro_torch.launch.serve``)."""
