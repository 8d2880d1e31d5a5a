"""The port's serving API (``server.py``) and its monitoring (``monitoring.py``)."""

from .server import GenerationService, serve

__all__ = ["GenerationService", "serve"]
