"""Parameters by checkpoint key, widened to float32 at each read, so the
served bf16 weights are held once and each layer's float32 copy lives
only while that layer runs."""

from typing import Dict

import torch


class StateParams:
    def __init__(self, state: Dict[str, torch.Tensor]):
        self.state = state
        self.keys = state.keys()

    def __call__(self, key: str) -> torch.Tensor:
        return self.state[key].float()
