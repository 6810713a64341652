"""Sources (videotestsrc)."""
