"""Packaged browser UI (index.html) served by the engine at GET /."""
