"""Decode services of the port: the bits-interchange stream decoder."""
