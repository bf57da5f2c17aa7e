"""Launchers: ``python -m repro_torch.launch.serve`` (the serving entry point)."""
