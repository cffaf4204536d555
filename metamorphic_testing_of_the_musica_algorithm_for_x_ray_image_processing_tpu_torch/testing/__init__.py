"""Test fixtures of the port: synthetic radiographs."""
