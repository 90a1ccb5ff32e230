"""Device selection shared by every entry point of the port.

`device=None` means the CUDA card. With no card present that raises: the
port never falls back to the CPU on its own, the caller asks for it with
`device="cpu"` (as the tests do).
"""

import torch


def resolve_device(device=None) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device
