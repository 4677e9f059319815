"""Helpers for holding the port against other engines in tests."""
