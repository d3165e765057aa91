"""Logging, meters and profiling of the port's loop."""
