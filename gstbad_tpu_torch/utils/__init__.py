"""Tracing and the declarative scenario runner."""
