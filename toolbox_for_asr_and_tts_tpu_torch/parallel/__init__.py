"""Serving-side batching: many streaming sessions per device step."""
