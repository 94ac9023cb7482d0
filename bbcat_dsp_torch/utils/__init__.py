"""Helpers around the engines."""
