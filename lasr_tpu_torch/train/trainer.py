"""The train step (counterpart of ``lasr_tpu/train/trainer.py``'s
``Trainer``: ``init_state``, ``train_step``, ``valid_step``,
``save_hparams``, ``save_checkpoint``).

One ``train_step`` is, as ``lasr_tpu``'s jitted ``_train_step``: the device
frontend with SpecAugment, ``pack_s2s``, the model forward in train mode,
``E2E_Loss``, the backward, clipping to a global norm of ``grad_clip``,
Adam with its schedule, and the EMA update, with the metrics
``loss_main``, ``att_loss``, ``ctc_loss``, ``att_corr``, ``ctc_cer`` and
``grad_norm`` (of the unclipped gradient).  ``acc_grads = k`` has
``optax.MultiSteps`` semantics: the gradients of k calls are averaged, and
the k-th call clips and updates once; BatchNorm statistics and the EMA
move on every call.

The model is updated in place; ``TrainState`` carries the step count, the
optimizer moments, the accumulated gradient and the EMA shadow.  Dropout
and SpecAugment draw from two ``torch.Generator``s made for each step from
``(seed, step)``, the counterpart of ``fold_in(rng, step)``; nothing draws
from torch's global RNG.

Checkpoints are the reference Lightning layout: ``{"state_dict":
{"model.<name>": ..., "model_ema.<name without dots>": ...}}``, which the
``ASRProcess`` of both packages reads (EMA shadow preferred).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import yaml

from lasr_tpu_torch import resolve_device
from lasr_tpu_torch.data.frontend import DeviceFrontend, pack_s2s
from lasr_tpu_torch.modules.dropout import dropout_generator
from lasr_tpu_torch.train.ema import ema_init, ema_update
from lasr_tpu_torch.train.optimizer import clip_by_global_norm, global_norm

METRICS = ("loss_main", "att_loss", "ctc_loss", "att_corr", "ctc_cer",
           "grad_norm")


@dataclass
class TrainState:
    step: int
    opt_state: Dict
    ema: Optional[Dict] = None
    acc_grads: Optional[List[torch.Tensor]] = None
    mini_step: int = 0


def _fold(seed: int, step: int, stream: int) -> int:
    """A 63-bit generator seed from (seed, step, stream) (splitmix64)."""
    z = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9
         + stream * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


class Trainer:
    def __init__(self, model, criterion, optimizer, frontend: DeviceFrontend,
                 tokenizer=None, exp_dir: Optional[str] = None,
                 use_ema: bool = False, ema_decay: float = 0.9999,
                 grad_clip: float = 5.0, acc_grads: int = 1, seed: int = 0,
                 log_interval: int = 50, device=None):
        """``optimizer``: an ``Adam`` / ``Noam`` descriptor or the update
        ``build_optimizer`` returns.  ``device=None`` means CUDA (raises
        without a GPU); the model must already live there."""
        self.device = resolve_device(device)
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer.make() if hasattr(optimizer, "make") \
            else optimizer
        self.frontend = frontend
        self.tokenizer = tokenizer
        self.exp_dir = exp_dir
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.grad_clip = grad_clip
        self.acc_grads = acc_grads
        self.seed = seed
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.sos = tokenizer.ID_VALUE_SOS if tokenizer else 1
        self.eos = tokenizer.ID_VALUE_EOS if tokenizer else 2
        self.ignore = tokenizer.ID_VALUE_IGNORE if tokenizer else -1
        if getattr(criterion, "ctc_cer_interval", 0) is None:
            criterion.ctc_cer_interval = max(1, min(log_interval, 1000))

    # ---- state ----

    def init_state(self) -> TrainState:
        """The optimizer and EMA state of the model's current weights (the
        weights themselves live in the model)."""
        return TrainState(step=0, opt_state=self.optimizer.init(self.params),
                          ema=ema_init(self.params) if self.use_ema else None)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.params)

    # ---- steps ----

    def _generators(self, step: int):
        """(SpecAugment generator, dropout generator) of ``step``."""
        return tuple(torch.Generator(device=self.device).manual_seed(
            _fold(self.seed, step, stream)) for stream in (0, 1))

    def _batch(self, batch: Dict):
        return [torch.as_tensor(batch[k], device=self.device)
                for k in ("wav_array", "wav_len", "token_id", "token_len")]

    def _forward(self, batch: Dict, step: Optional[int], train: bool):
        wav, wav_len, token_id, token_len = self._batch(batch)
        g_spec, g_drop = self._generators(step or 0)
        self.model.train(train)
        with torch.no_grad():
            feats, feat_len = self.frontend(wav, wav_len, generator=g_spec,
                                            train=train)
        ys_in, att_label, ctc_label = pack_s2s(token_id, token_len, self.sos,
                                               self.eos, self.ignore)
        with dropout_generator(g_drop):
            out = self.model(feats, feat_len, ys_in.long())
        data = dict(out, att_label=att_label, ctc_label=ctc_label)
        if step is not None:
            data["step"] = step
        return data, wav_len

    def loss_and_grads(self, batch: Dict, step: int = 0):
        """The train-mode metrics of ``batch`` at ``step`` and the
        gradient of ``loss_main`` for every parameter (in
        ``named_parameters`` order); nothing is updated but the BatchNorm
        statistics."""
        data, _ = self._forward(batch, step, train=True)
        metrics = self.criterion.train_forward(data)
        grads = torch.autograd.grad(metrics["loss_main"], self.params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        metrics["grad_norm"] = global_norm(grads)
        return metrics, grads

    def train_step(self, state: TrainState, batch: Dict):
        """One step on a host batch ``{wav_array, wav_len, token_id,
        token_len}`` (numpy or tensors); returns (state, metrics as
        floats)."""
        metrics, grads = self.loss_and_grads(batch, state.step)
        emit = True
        if self.acc_grads > 1:
            acc = state.acc_grads or [torch.zeros_like(g) for g in grads]
            n = state.mini_step
            acc = [a + (g - a) / (n + 1) for a, g in zip(acc, grads)]
            emit = n == self.acc_grads - 1
            state.mini_step = (n + 1) % self.acc_grads
            state.acc_grads = None if emit else acc
            grads = acc
        if emit:
            self.optimizer.step(self.params,
                                clip_by_global_norm(grads, self.grad_clip),
                                state.opt_state)
        if self.use_ema:
            ema_update(state.ema, self.params, self.ema_decay)
        state.step += 1
        values = torch.stack([metrics[k].detach().float().reshape(())
                              for k in METRICS]).tolist()
        return state, dict(zip(METRICS, values))

    @torch.no_grad()
    def valid_step(self, state: TrainState, batch: Dict) -> Dict[str, float]:
        """Eval-mode metrics, with the EMA shadow's weights when
        ``use_ema``."""
        live = None
        if self.use_ema:
            live = [p.detach().clone() for p in self.params]
            torch._foreach_copy_(self.params, state.ema["shadow"])
        try:
            data, wav_len = self._forward(batch, None, train=False)
            metrics = self.criterion.valid_forward(data)
        finally:
            if live is not None:
                torch._foreach_copy_(self.params, live)
        out = {k: float(v) for k, v in metrics.items()}
        out["n_utts"] = max(int((wav_len > 0).sum()), 1)
        return out

    # ---- files ----

    def save_hparams(self, configs: Dict) -> None:
        os.makedirs(self.exp_dir, exist_ok=True)
        with open(os.path.join(self.exp_dir, "hparams.yaml"), "w") as f:
            yaml.safe_dump(configs, f, sort_keys=False, allow_unicode=True)

    def save_checkpoint(self, state: TrainState,
                        path: Optional[str] = None) -> str:
        """Write the reference Lightning ``.ckpt`` (model weights and
        BatchNorm statistics under ``model.``, the EMA shadow under
        ``model_ema.`` with the dots of each name removed, as LitEma keys
        it); returns its path (default ``exp_dir/checkpoints/
        step-<step>.ckpt``)."""
        if path is None:
            path = os.path.join(self.exp_dir, "checkpoints",
                                f"step-{state.step}.ckpt")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        sd = {f"model.{k}": v.detach().cpu()
              for k, v in self.model.state_dict().items()}
        if state.ema is not None:
            for name, s in zip(self.names, state.ema["shadow"]):
                sd["model_ema." + name.replace(".", "")] = s.detach().cpu()
            sd["model_ema.decay"] = torch.tensor(self.ema_decay,
                                                 dtype=torch.float32)
            sd["model_ema.num_updates"] = torch.tensor(
                state.ema["num_updates"], dtype=torch.int32)
        torch.save({"state_dict": sd, "global_step": state.step}, path)
        return path
