"""Host byte formats (numpy only): y4m and ICC profiles."""
