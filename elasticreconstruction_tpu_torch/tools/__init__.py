"""Measurement scripts of the port that are no part of the pipeline."""
