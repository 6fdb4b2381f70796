"""Synthetic traffic datasets (numpy), copied from the reference."""
