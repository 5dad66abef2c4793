"""Convolutional code inference of the port."""
