"""Utilities of the port: profiling, metrics, seeding, filters."""
