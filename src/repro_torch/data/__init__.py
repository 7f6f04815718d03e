"""The lineage-aware training-data pipeline."""
