"""Core: specs, frames, elements, table fusion, pipeline."""
