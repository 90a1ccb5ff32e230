"""Compute ops on tensors: support codecs, stacking, search."""
