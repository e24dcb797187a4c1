"""Serving: prefill a prompt batch, decode greedily."""
