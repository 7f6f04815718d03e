"""Plain PyTorch version of the membership probe: ``isin`` as int32.  The
wrapper in ``membership.py`` runs it for tensors that lie on the CPU."""

import torch


def membership_ref(values, vset):
    return torch.isin(values, vset).to(torch.int32)
