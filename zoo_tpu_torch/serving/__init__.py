"""Serving stacks of the port."""
