"""Analysis elements: compare and iqa."""
