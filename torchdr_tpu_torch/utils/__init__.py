"""Utilities: logging, validation, input formats, optimizers, schedules."""
