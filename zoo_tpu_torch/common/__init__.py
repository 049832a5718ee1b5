"""Shared plumbing of the port: the knob registry and device resolution."""
