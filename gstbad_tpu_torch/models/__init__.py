"""Benchmark pipeline graphs."""
