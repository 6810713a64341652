"""Host byte formats (numpy only): y4m."""
