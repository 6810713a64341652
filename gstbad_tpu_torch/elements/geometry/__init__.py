"""Geometric warp elements (gst/geometrictransform/)."""
