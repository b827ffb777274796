"""Evaluation metrics on the host and step timing / tracing."""
