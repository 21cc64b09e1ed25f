"""AdamW with f32 master weights (counterpart of ``repro/optim``)."""
