"""Fully-connected code inference of the port."""
