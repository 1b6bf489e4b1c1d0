"""Distributed and batched execution layer: independent registrations
stacked on a batch axis (``align_pairs``), sharded over the ranks of a
``torch.distributed`` group when a mesh spans more than one
(``multihost``)."""
from .align_pairs import (align_pairs, align_pairs_sharded, align_pair_list,
                          make_submap_mesh, pad_pairs, stack_pairs)

__all__ = [
    "align_pairs", "align_pairs_sharded", "align_pair_list",
    "make_submap_mesh", "pad_pairs", "stack_pairs",
]
