"""Fault tolerance for the training loop (counterpart of ``repro/runtime``)."""
