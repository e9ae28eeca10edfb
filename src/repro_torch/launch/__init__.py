"""Launchers: the port of ``repro/launch`` for one card (no mesh yet)."""
