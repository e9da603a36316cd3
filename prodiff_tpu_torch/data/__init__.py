"""Datasets, collation and batching of the port."""
