"""Video filter elements, and the frei0r host, whose elements are
registered from the plugins found on a path."""
