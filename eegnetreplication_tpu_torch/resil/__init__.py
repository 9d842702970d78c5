"""Resilience primitives the serving path needs: checkpoint integrity and
graceful stop on SIGTERM."""
