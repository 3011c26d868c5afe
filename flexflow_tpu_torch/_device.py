"""Device selection: the port's counterpart of the JAX package's ``_env.py``.

Entry points run on the card. ``"cuda"`` is the default; the CPU is used
only when the caller asks for it (the parity tests do, and there every
kernel wrapper takes its plain PyTorch version). Without a card and
without ``device="cpu"`` resolution raises: the port never falls back to
the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "flexflow_tpu_torch runs on a CUDA device by default and "
                "this process sees none; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device={device!r}: must be 'cuda[:N]' or 'cpu'")
    return dev
