"""Serving benchmark and served-path check."""
