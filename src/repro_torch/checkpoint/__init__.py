"""Checkpoints of nested dicts of tensors (the reference's
src/repro/checkpoint/, on the reference's on-disk format)."""
