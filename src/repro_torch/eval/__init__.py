"""Downstream evaluation of the port (link-prediction F1)."""
