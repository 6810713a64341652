"""Video filter elements."""
