"""Batched execution layer: independent registrations stacked on a batch
axis (``align_pairs``)."""
