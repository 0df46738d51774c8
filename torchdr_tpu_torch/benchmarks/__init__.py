"""Benchmarks of the port: counterparts of the repository's ``benchmarks/``."""
