"""The multilevel collectives over ``torch.distributed`` and the slow-link
int8 compression (counterpart of ``repro/core``; the planning plane comes
in a later slice)."""
