"""Observability of the port: the launchers' structured logger."""
