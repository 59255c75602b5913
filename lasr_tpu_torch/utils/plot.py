"""Attention-map harvest and plots (counterpart of
``lasr_tpu/utils/plot.py``).

The maps come from ``modules.attention.capture_attention``: every
attention module whose forward computes its probabilities records its
first post-softmax map, the counterpart of the JAX modules' ``sow`` into
'intermediates'.  They are keyed by the module's name in the model
(``encoder.encoders.0.self_attn``, the reference state_dict's names).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from lasr_tpu_torch.modules.attention import capture_attention


def collect_attention_maps(model: torch.nn.Module, captured: Dict
                           ) -> Dict[str, np.ndarray]:
    """{module name: (B, H, L, T) float32 array} of a capture's maps."""
    return {name: captured[m].float().cpu().numpy()
            for name, m in model.named_modules() if m in captured}


@torch.no_grad()
def calculate_all_attentions(model: torch.nn.Module, x, xlen, ys_in
                             ) -> Dict[str, np.ndarray]:
    """Run an eval-mode forward and harvest every attention map."""
    was_training = model.training
    model.eval()
    try:
        with capture_attention() as captured:
            model(x, xlen, ys_in)
    finally:
        model.train(was_training)
    return collect_attention_maps(model, captured)


def plot_multi_head_attention(att_maps: Dict[str, np.ndarray], out_dir: str,
                              uid: str = "utt") -> None:
    """Save one PNG of per-head heatmaps per attention module. Requires
    matplotlib (optional dependency)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("matplotlib is required for attention plots") from e
    os.makedirs(out_dir, exist_ok=True)
    for name, att in att_maps.items():
        a = att[0]  # first utterance: (H, L, T)
        H = a.shape[0]
        fig, axes = plt.subplots(1, H, figsize=(3 * H, 3), squeeze=False)
        for h in range(H):
            axes[0][h].imshow(a[h], aspect="auto", origin="lower")
            axes[0][h].set_title(f"head {h}")
        fig.suptitle(name)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{uid}.{name}.png"))
        plt.close(fig)
