"""Synthetic patch data and the data pipeline (numpy copies of the
reference's)."""
