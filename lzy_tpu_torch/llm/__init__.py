"""Workflow-native LLM surface: the metrics and model digest the
serving fronts use (``metrics``, ``backend``)."""
