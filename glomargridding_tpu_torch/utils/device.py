"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

import torch


def resolve_device(device=None, *inputs) -> torch.device:
    """The device of an entry point's call.

    An explicit `device` wins. Otherwise the first tensor among `inputs`
    keeps its device. Otherwise (numpy inputs, no device named) the call
    runs on ``cuda``; without a card that raises ``RuntimeError`` rather
    than falling back to the CPU.
    """
    if device is not None:
        return torch.device(device)
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for the CPU (device='cpu', or CPU tensors)"
        )
    return torch.device("cuda")
