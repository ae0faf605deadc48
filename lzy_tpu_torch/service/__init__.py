"""Builders that turn a model name into a started serving engine."""
