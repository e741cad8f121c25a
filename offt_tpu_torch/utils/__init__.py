"""Configuration (``config.get``)."""
