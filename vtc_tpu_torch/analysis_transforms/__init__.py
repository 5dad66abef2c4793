"""Code inference (analysis transforms) of the port."""
