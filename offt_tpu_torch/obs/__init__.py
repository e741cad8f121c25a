"""Observability: device timing (``profile.time_cuda``)."""
