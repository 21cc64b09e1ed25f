"""The synthetic data pipeline (counterpart of ``repro/data``)."""
