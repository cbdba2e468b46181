"""Typed experiment configurations and sweep tables (port of ``config/``)."""
