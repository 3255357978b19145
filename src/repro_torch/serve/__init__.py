"""Serving telemetry of the port (the engines wait for a later slice)."""
