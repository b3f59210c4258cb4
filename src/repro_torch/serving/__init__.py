"""Serving: backends behind one protocol, sampling, continuous batching."""
