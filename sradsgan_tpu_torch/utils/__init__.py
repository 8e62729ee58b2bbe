"""Logging helpers of the port."""
