# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises.

    The port runs on the card unless the caller asks for the CPU
    (``device="cpu"``, as the tests do): a missing card is an error,
    never a quiet move to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested (device=None means cuda) "
            "but torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    return dev
