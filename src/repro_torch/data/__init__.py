"""Synthetic data and partitioning, numpy only (own copy of the reference's)."""
