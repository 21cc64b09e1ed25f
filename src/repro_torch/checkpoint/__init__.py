"""Atomic, asynchronous checkpoints (counterpart of ``repro/checkpoint``)."""
