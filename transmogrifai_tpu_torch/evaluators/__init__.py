"""Evaluators and metric functions on torch tensors."""
