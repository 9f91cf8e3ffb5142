"""Sampling entry points of the port."""
