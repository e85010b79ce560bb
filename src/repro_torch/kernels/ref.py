"""Plain PyTorch oracles of the kernel entry points (the port's copy of
``repro.kernels.ref``): every function here states what a kernel of
:mod:`repro_torch.kernels.ops` computes, in a few torch ops."""
from __future__ import annotations

import torch

from repro_torch.core.index import INVALID_DOC


def intersect_mask_ref(a_docs: torch.Tensor, a_attrs: torch.Tensor,
                       b_docs: torch.Tensor, attr_filter=-1) -> torch.Tensor:
    """Membership of each ``a`` in the sorted ``b``, fused with the
    embedded-attribute predicate: a posting survives when it is real (not
    padding), its docID occurs in ``b``, and (limited search, filter >= 0)
    its attribute equals the filter.  Returns int32 of ``a_docs``' shape."""
    valid = a_docs != int(INVALID_DOC)
    idx = torch.searchsorted(b_docs, a_docs).clamp(max=b_docs.shape[0] - 1)
    member = (b_docs[idx] == a_docs) & valid
    filt = torch.as_tensor(attr_filter, device=a_docs.device)
    attr_ok = torch.where(filt >= 0, a_attrs == filt, True)
    return (member & attr_ok).to(torch.int32)


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort: the oracle of the flat sort."""
    return torch.sort(x).values


def merge_topk_ref(cands: torch.Tensor, k: int) -> torch.Tensor:
    """The global best k (smallest ids) of stacked candidates ``cands``
    [ns, k'], ascending: the loser tree's output."""
    return torch.sort(cands.reshape(-1)).values[:k]
