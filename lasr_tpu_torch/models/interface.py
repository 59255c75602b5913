"""The dict-in/dict-out model contract (counterpart of
``lasr_tpu/models/interface.py``).

The port's models return their output dict from ``forward``; this
interface documents the contract for host-side wrappers (criteria and
composed pipelines) and provides the identity model.
"""

from __future__ import annotations

from typing import Dict


class Model_Interface:
    def get_input_dict(self) -> Dict:
        raise NotImplementedError

    def get_out_dict(self) -> Dict:
        raise NotImplementedError

    def train_forward(self, input_dict: Dict) -> Dict:
        raise NotImplementedError

    def valid_forward(self, input_dict: Dict) -> Dict:
        return self.train_forward(input_dict)


class EnptyModel(Model_Interface):
    """Identity pass-through (the reference's name, typo included, for
    config compatibility)."""

    def __init__(self, x=None) -> None:
        self.x = x

    def train_forward(self, input_dict: Dict) -> Dict:
        return input_dict
