"""Batched serving: prefill and decode steps and the engine."""
