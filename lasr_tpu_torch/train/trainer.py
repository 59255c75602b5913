"""The trainer (counterpart of ``lasr_tpu/train/trainer.py``'s
``Trainer``): ``init_state``, ``train_step``, ``valid_step``, ``fit``,
``validate``, the checkpoint lifecycle and ``save_hparams``.

One ``train_step`` is, as ``lasr_tpu``'s jitted ``_train_step``: the device
frontend with SpecAugment, ``pack_s2s``, the model forward in train mode,
``E2E_Loss``, the backward, clipping to a global norm of ``grad_clip``,
Adam with its schedule, and the EMA update, with the criterion's metrics
(``loss_main``, ``att_loss``, ``ctc_loss``, ``att_corr``, ``ctc_cer``
for ``E2E_Loss``) and ``grad_norm`` (of the unclipped gradient).  ``acc_grads = k`` has
``optax.MultiSteps`` semantics: the gradients of k calls are averaged, and
the k-th call clips and updates once; BatchNorm statistics and the EMA
move on every call.

The model is updated in place; ``TrainState`` carries the step count, the
optimizer moments, the accumulated gradient and the EMA shadow.  Dropout
and SpecAugment draw from two ``torch.Generator``s made for each step from
``(seed, step)``, the counterpart of ``fold_in(rng, step)``; nothing draws
from torch's global RNG.

``fit`` runs epochs over a dataset's ``batches(shuffle=True, seed=seed +
epoch)``, validates, writes ``metrics.jsonl`` every ``log_interval``
steps and keeps two checkpoint directories, as ``lasr_tpu``'s orbax
managers do: ``exp_dir/checkpoints/last/`` the newest ``checkpoint_keep``
by step, ``exp_dir/checkpoints/best/`` the ``checkpoint_keep`` with the
lowest ``valid_loss_main``.  ``loop_state.json`` beside them maps each
saved step to its (epoch, batch), so ``auto_resume`` re-enters the same
batch mid-epoch.

Data parallelism (``lasr_tpu_torch.parallel``): under a process group of
N ranks each rank trains on its rows of the global batch (the dataset's
``batches`` or ``parallel.dist.shard_rows`` give them) and a step equals
the one-process step on the global batch, as ``lasr_tpu``'s one program
on a data axis does: BatchNorm's statistics and every loss denominator
are the global batch's, SpecAugment draws for the global rows from the
shared (seed, step) generator, the gradient is summed over the ranks
once per optimizer step (for ``acc_grads`` > 1 at the emitting call,
after the running mean) before clipping, and the metrics are the global
ones.  Dropout draws from a generator keyed on (seed, step, rank), so its
draws differ from a one-process run's (as they differ from JAX's).
``grad_norm`` is the global norm of the call's gradient; with
``acc_grads`` > 1 over several ranks a call's gradient is summed over the
ranks only on the steps whose metrics are logged (those of the greedy
CER), and other calls report -1.  Rank 0's initial weights are broadcast
to every rank; rank 0 alone writes checkpoints, ``hparams.yaml``,
``metrics.jsonl`` and the loop state, and every rank restores.

The (data, pipe, seq, model) grid (``dist.init(..., model_parallel=M,
seq_parallel=S, pipeline_parallel=P)``), as ``lasr_tpu``'s Trainer
takes its mesh: with P > 1 the model's ``encoder_pipeline_stages`` must
be a multiple of P (``ValueError`` otherwise), and each pipe rank keeps
the encoder blocks of its stages (``modules.pipeline``); with S > 1 (and
P = 1) the Trainer sets the encoder's ``act_sharding``, so the encoder's
time axis splits over the S seq ranks and the encoder's gradients sum
over them (a model without the field trains with the seq ranks
repeating the work, with a warning; with P > 1 too the time stays whole
inside the pipeline stages, as ``lasr_tpu`` logs).  The Trainer splits
the model's layers over the M model ranks of each data index
(``parallel.tensor``, the rules of ``parallel.sharding``) after the
broadcast, and with ``fsdp`` keeps every large leaf's parameters,
gradients, Adam moments, accumulated gradient and EMA shadow as the data
rank's shard (``sharding.ShardLayout``): the whole weights are gathered
for a step and freed after it, the gradients reduce-scattered, and the
clip's global norm counts every shard once.  The data-parallel rules
above then hold over the data ranks, the model ranks of a data index
drawing the same dropout.  Checkpoints stay whole reference ``.ckpt``
files, gathered from the shards, so a run resumes on any layout.

``fit`` also writes each ``metrics.jsonl`` train line's numeric fields
(but ``epoch`` and ``step``) as TensorBoard scalars at the line's step,
from rank 0, under ``exp_dir/tb`` (``_ScalarWriter``; without the
``tensorboard`` package nothing is written).  A dataset with
``device_audio_cache`` trains through a device audio pool
(``_DeviceAudioPool``): the first epoch's batches scatter their waves
into a (rows + 1, S_max) tensor on the device, later epochs ship only
row indices and gather; under a process group of more than one rank the
pool is off and the waves cross as they do without it.

Checkpoints are reference Lightning ``.ckpt`` files named
``step-<step, 9 digits>.ckpt`` (names sort by step): ``state_dict`` with
the model's weights and BatchNorm statistics under ``model.`` and the EMA
shadow under ``model_ema.`` (the dots of each name removed, as LitEma keys
it), which the ``ASRProcess`` of both packages reads; ``global_step``;
``optimizer_states`` (Adam's moments and count, in ``torch.optim.Adam``'s
state_dict layout); and the accumulated gradient with ``mini_step``.
Restoring one gives back the whole train state.  ``restore_checkpoint``
also takes an orbax step directory of ``lasr_tpu``'s Trainer (the train
CLI's ``-resume_ckpt``): its step, weights, BatchNorm statistics, optax
Adam state and EMA, mapped by the weight bridge's names.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import socket
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import yaml

from lasr_tpu_torch import resolve_device
from lasr_tpu_torch.data.frontend import DeviceFrontend, pack_s2s
from lasr_tpu_torch.modules.dropout import dropout_generator
from lasr_tpu_torch.parallel import dist, sharding
from lasr_tpu_torch.parallel.tensor import apply_tensor_parallel
from lasr_tpu_torch.train.ema import ema_init, ema_update
from lasr_tpu_torch.train.optimizer import clip_by_global_norm
from lasr_tpu_torch.utils.ocdbt import load_tree
from lasr_tpu_torch.utils.weights import (checkpoint_name, checkpoint_steps,
                                          flax_to_state_dict, orbax_item,
                                          unstack_scan_layers)

# a step's metrics under E2E_Loss (a criterion's own keys and grad_norm
# in general)
METRICS = ("loss_main", "att_loss", "ctc_loss", "att_corr", "ctc_cer",
           "grad_norm")
# best/'s index: {file name: valid_loss_main}
BEST_INDEX = "valid_loss.json"


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
                 log_interval: int = 50, checkpoint_keep: int = 10,
                 schedule=None, device=None, fsdp: bool = False,
                 fsdp_min_size: int = sharding.FSDP_MIN_SIZE):
        """``optimizer``: an ``Adam`` / ``Noam`` descriptor (made with
        ``schedule``) or the update ``build_optimizer`` returns;
        ``schedule`` is also what ``metrics.jsonl``'s ``lr`` reads.
        ``device=None`` means CUDA (raises without a GPU); the model must
        already live there.  Under a process group, the model's weights
        and buffers become rank 0's, then the model is split over the
        grid's model ranks; ``fsdp`` shards the leaves of at least
        ``fsdp_min_size`` elements over the data ranks
        (``sharding.param_specs``)."""
        self.device = resolve_device(device)
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer.make(schedule) \
            if hasattr(optimizer, "make") else optimizer
        self.schedule = schedule
        self.frontend = frontend
        self.tokenizer = tokenizer
        self.exp_dir = exp_dir
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.grad_clip = grad_clip
        self.acc_grads = acc_grads
        self.seed = seed
        self.log_interval = log_interval
        self.checkpoint_keep = checkpoint_keep
        self.sos = tokenizer.ID_VALUE_SOS if tokenizer else 1
        self.eos = tokenizer.ID_VALUE_EOS if tokenizer else 2
        self.ignore = tokenizer.ID_VALUE_IGNORE if tokenizer else -1
        if getattr(criterion, "ctc_cer_interval", 0) is None:
            criterion.ctc_cer_interval = max(1, min(log_interval, 1000))
        self.rank, self.world = dist.rank(), dist.world_size()
        grid = dist.grid()
        self.data_world = grid.data_size
        seq_split = _setup_grid_model(model, grid)
        dist.broadcast_module(model)
        specs = sharding.param_specs(model, grid.model_size, grid.data_size,
                                     fsdp, fsdp_min_size, grid.pipe_size,
                                     seq_split)
        apply_tensor_parallel(model, specs)
        self.layout = sharding.ShardLayout(model, specs)
        self.names = self.layout.names
        # the module's parameters, and what the optimizer updates (the
        # FSDP leaves' shards; the parameters themselves elsewhere)
        self.params = self.layout.params
        self.masters = self.layout.masters
        self._tb = None

    def _tb_writer(self):
        """The TensorBoard writer of rank 0, made at first use; None
        elsewhere, without ``exp_dir`` or without the package."""
        if self._tb is None and self.exp_dir and self.rank == 0:
            try:
                self._tb = _ScalarWriter(os.path.join(self.exp_dir, "tb"))
            except ImportError:
                self._tb = False
        return self._tb or None

    # ---- state ----

    def init_state(self) -> TrainState:
        """The optimizer and EMA state of the model's current weights (the
        weights themselves live in the model)."""
        return TrainState(step=0, opt_state=self.optimizer.init(self.masters),
                          ema=ema_init(self.masters) if self.use_ema else None)

    def param_count(self) -> int:
        """The whole model's parameters, whatever the split."""
        return sum(int(torch.Size(s).numel())
                   for s in self.layout.full_shapes)

    def full_state_dict(self, source=None) -> Dict[str, torch.Tensor]:
        """The whole model's state_dict: every parameter from its shards
        (``source``: the masters, or shard-shaped tensors such as the EMA
        shadow) and the buffers (every rank calls it under a split)."""
        source = self.masters if source is None else source
        index = {n: i for i, n in enumerate(self.names)}
        out = {}
        for k, v in self.layout.full_buffers(
                self.model.state_dict()).items():
            i = index.get(k)
            out[k] = v if i is None else self.layout.full(i, source[i])
        return out

    # ---- steps ----

    def _generators(self, step: int):
        """(SpecAugment generator, dropout generator) of ``step``: the
        first is every rank's, the second this rank's."""
        return tuple(torch.Generator(device=self.device).manual_seed(
            _fold(self.seed, step, stream))
            for stream in (0, 1 + dist.data_rank()))

    def _batch(self, batch: Dict):
        return [torch.as_tensor(batch[k], device=self.device)
                for k in ("wav_array", "wav_len", "token_id", "token_len")]

    def _rows(self, batch: Dict):
        """The frontend's ``rows`` of a rank's batch; None at world size
        1."""
        if self.data_world == 1:
            return None
        if "row0" not in batch:
            raise ValueError(
                "under a process group a batch is a rank's rows of the "
                "global batch: take it from the dataset's batches(...) or "
                "parallel.dist.shard_rows")
        return (int(batch["row0"]),
                torch.as_tensor(batch["global_wav_len"], device=self.device))

    def _forward(self, batch: Dict, step: Optional[int], train: bool):
        wav, wav_len, token_id, token_len = self._batch(batch)
        g_spec, g_drop = self._generators(step or 0)
        self.model.train(train)
        with torch.no_grad():
            feats, feat_len = self.frontend(wav, wav_len, generator=g_spec,
                                            train=train,
                                            rows=self._rows(batch))
        ys_in, att_label, ctc_label = pack_s2s(token_id, token_len, self.sos,
                                               self.eos, self.ignore)
        # the shared draws (the dual encoder's chunk size) come from the
        # SpecAugment generator, in the same state on every rank
        with dropout_generator(g_drop, shared=g_spec):
            out = self.model(feats, feat_len, ys_in.long())
        data = dict(out, att_label=att_label, ctc_label=ctc_label)
        if step is not None:
            data["step"] = step
        return data, wav_len

    def _local_loss_and_grads(self, batch: Dict, step: int):
        """This rank's share of the metrics (the global ones summed over
        the ranks) and of the gradient of ``loss_main``."""
        data, _ = self._forward(batch, step, train=True)
        metrics = self.criterion.train_forward(data)
        grads = torch.autograd.grad(metrics["loss_main"], self.params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        return self._global_metrics(metrics), grads

    def _global_metrics(self, metrics: Dict) -> Dict:
        """The ranks' shares summed (one all-reduce); the greedy CER's -1
        of a step that skips it stays -1."""
        if self.data_world == 1:
            return metrics
        keys = list(metrics)
        local = torch.stack([metrics[k].detach().float().reshape(())
                             for k in keys])
        total = dist.global_sum(local)
        out = dict(zip(keys, total.unbind()))
        if "ctc_cer" in out:
            cer = local[keys.index("ctc_cer")]
            out["ctc_cer"] = torch.where(cer < 0, cer, out["ctc_cer"])
        return out

    def _logged(self, step: int) -> bool:
        """Whether the call at ``step`` computes its metrics in full (the
        criterion's ``logs_step``; every call for a criterion without
        one)."""
        logs_step = getattr(self.criterion, "logs_step", None)
        return logs_step is None or logs_step(step)

    def loss_and_grads(self, batch: Dict, step: int = 0):
        """The train-mode metrics of ``batch`` at ``step`` and the
        gradient of ``loss_main`` for every parameter (in
        ``named_parameters`` order), of the global batch under a process
        group (the rank's parts under a split: ``layout.full_list`` gives
        the whole); nothing is updated but the BatchNorm statistics."""
        self.layout.gather()
        try:
            metrics, grads = self._local_loss_and_grads(batch, step)
        finally:
            self.layout.release()
        grads = self.layout.reduce(grads)
        metrics["grad_norm"] = self.layout.norm(grads)
        return metrics, grads

    def train_step(self, state: TrainState, batch: Dict):
        """One step on a host batch ``{wav_array, wav_len, token_id,
        token_len}`` (numpy or tensors; under a process group a rank's
        rows of it); returns (state, metrics as floats).  With FSDP the
        gradient is reduce-scattered at every call, so the accumulator
        holds shards of the summed gradient."""
        self.layout.gather()
        try:
            metrics, grads = self._local_loss_and_grads(batch, state.step)
        finally:
            self.layout.release()
        reduced = self.layout.fsdp or (self.data_world == 1
                                       and not self.layout.seq)
        if self.layout.fsdp:
            grads = self.layout.reduce(grads)
        emit = True
        if self.acc_grads > 1:
            if reduced:
                metrics["grad_norm"] = self.layout.norm(grads)
            elif self._logged(state.step):
                metrics["grad_norm"] = self.layout.norm(
                    self.layout.reduce(grads))
            else:
                metrics["grad_norm"] = torch.tensor(-1.0,
                                                    device=self.device)
            acc = state.acc_grads or [torch.zeros_like(g) for g in grads]
            n = state.mini_step
            acc = [a + (g - a) / (n + 1) for a, g in zip(acc, grads)]
            emit = n == self.acc_grads - 1
            state.mini_step = (n + 1) % self.acc_grads
            state.acc_grads = None if emit else acc
            grads = acc
        if emit:
            if not self.layout.fsdp:
                grads = self.layout.reduce(grads)
            norm = self.layout.norm(grads)
            if self.acc_grads == 1:
                metrics["grad_norm"] = norm
            self.optimizer.step(
                self.masters,
                clip_by_global_norm(grads, self.grad_clip, norm),
                state.opt_state)
        if self.use_ema:
            ema_update(state.ema, self.masters, self.ema_decay)
        state.step += 1
        keys = list(metrics)
        values = torch.stack([metrics[k].detach().float().reshape(())
                              for k in keys]).tolist()
        return state, dict(zip(keys, values))

    @torch.no_grad()
    def valid_step(self, state: TrainState, batch: Dict) -> Dict[str, float]:
        """Eval-mode metrics, with the EMA shadow's weights when
        ``use_ema``."""
        live = None
        if self.use_ema:
            live = [p.detach().clone() for p, s in zip(self.params,
                                                       self.layout.specs)
                    if s.fsdp is None]
        self.layout.gather(state.ema["shadow"] if self.use_ema else None)
        try:
            data, wav_len = self._forward(batch, None, train=False)
            metrics = self._global_metrics(
                self.criterion.valid_forward(data))
        finally:
            if live is not None:
                whole = [p for p, s in zip(self.params, self.layout.specs)
                         if s.fsdp is None]
                torch._foreach_copy_(whole, live)
            self.layout.release()
        out = {k: float(v) for k, v in metrics.items()}
        out["n_utts"] = max(int(dist.global_sum((wav_len > 0).sum())), 1)
        return out

    # ---- files ----

    def save_hparams(self, configs: Dict) -> None:
        """Write ``exp_dir/hparams.yaml`` (rank 0 only)."""
        if self.rank != 0:
            return
        os.makedirs(self.exp_dir, exist_ok=True)
        with open(os.path.join(self.exp_dir, "hparams.yaml"), "w") as f:
            yaml.safe_dump(configs, f, sort_keys=False, allow_unicode=True)

    def _checkpoint_root(self) -> str:
        return os.path.join(os.path.abspath(self.exp_dir), "checkpoints")

    def _checkpoint_blob(self, state: TrainState,
                         valid_loss: Optional[float]) -> Dict:
        """The whole train state, gathered from the shards (every rank
        calls it under a split; rank 0's is written)."""
        full = self.layout.full_list
        cpu = lambda ts: [t.detach().cpu() for t in full(ts)]  # noqa: E731
        sd = {f"model.{k}": v.detach().cpu()
              for k, v in self.full_state_dict().items()}
        if state.ema is not None:
            for name, s in zip(self.names, cpu(state.ema["shadow"])):
                sd["model_ema." + name.replace(".", "")] = s
            sd["model_ema.decay"] = torch.tensor(self.ema_decay,
                                                 dtype=torch.float32)
            sd["model_ema.num_updates"] = torch.tensor(
                state.ema["num_updates"], dtype=torch.int32)
        # Adam's moments and count in torch.optim.Adam's state_dict layout
        opt, adam = state.opt_state, self.optimizer
        count = torch.tensor(float(opt["count"]))
        optimizer_state = {
            "state": {i: {"step": count, "exp_avg": mu, "exp_avg_sq": nu}
                      for i, (mu, nu) in enumerate(zip(cpu(opt["mu"]),
                                                       cpu(opt["nu"])))},
            "param_groups": [{
                "params": list(range(len(self.params))),
                "lr": adam.learning_rate(opt["count"]),
                "betas": (adam.b1, adam.b2), "eps": adam.eps,
                "weight_decay": adam.weight_decay}]}
        return {"state_dict": sd, "global_step": state.step,
                "optimizer_states": [optimizer_state],
                "accumulated_grads": (None if state.acc_grads is None
                                      else cpu(state.acc_grads)),
                "mini_step": state.mini_step,
                "valid_loss_main": valid_loss}

    def save_checkpoint(self, state: TrainState,
                        valid_metrics: Optional[Dict] = None,
                        path: Optional[str] = None) -> str:
        """Write the whole train state as a reference Lightning ``.ckpt``
        and return its path.

        With ``path`` the file goes there and nothing else is touched.
        Otherwise it becomes ``exp_dir/checkpoints/last/<checkpoint_name>``
        and the oldest beyond ``checkpoint_keep`` are deleted; with
        ``valid_metrics`` it also enters ``best/`` (a hard link where the
        file system allows), which keeps the ``checkpoint_keep`` lowest
        ``valid_metrics["loss_main"]``.  Under a process group rank 0
        writes and every rank returns the path."""
        valid_loss = None if not valid_metrics \
            else float(valid_metrics["loss_main"])
        # a split's shards are gathered by every rank
        blob = self._checkpoint_blob(state, valid_loss) \
            if self.rank == 0 or self.layout.sharded else None
        if path is not None:
            if self.rank == 0:
                _atomic_save(blob, path)
            return path
        root = self._checkpoint_root()
        name = checkpoint_name(state.step)
        last = os.path.join(root, "last", name)
        if self.rank != 0:
            return last
        _atomic_save(blob, last)
        kept = checkpoint_steps(os.path.dirname(last))
        for step in sorted(kept)[:-self.checkpoint_keep]:
            os.remove(os.path.join(os.path.dirname(last), kept[step]))
        if valid_loss is not None:
            best_dir = os.path.join(root, "best")
            os.makedirs(best_dir, exist_ok=True)
            index_path = os.path.join(best_dir, BEST_INDEX)
            index = _read_json(index_path)
            best = os.path.join(best_dir, name)
            if os.path.exists(best):
                os.remove(best)
            try:
                os.link(last, best)
            except OSError:
                shutil.copyfile(last, best)
            index[name] = valid_loss
            kept = sorted(index, key=lambda n: (index[n], n))
            for n in kept[self.checkpoint_keep:]:
                del index[n]
                if os.path.exists(os.path.join(best_dir, n)):
                    os.remove(os.path.join(best_dir, n))
            _atomic_json(index, index_path)
        return last

    def latest_step(self) -> Optional[int]:
        """The newest step in ``exp_dir/checkpoints/last``, or None."""
        steps = checkpoint_steps(os.path.join(self._checkpoint_root(),
                                              "last"))
        return max(steps) if steps else None

    def restore_checkpoint(self, path: Optional[str] = None,
                           step: Optional[int] = None) -> TrainState:
        """Load a checkpoint of ``save_checkpoint`` back onto the trainer's
        device: the model's weights and BatchNorm statistics in place, and
        the returned ``TrainState`` (step, Adam moments and count, the
        EMA, the accumulated gradient and ``mini_step``).  ``path`` names a
        file, or an orbax step directory of ``lasr_tpu``'s Trainer
        (``_restore_orbax``); otherwise ``step`` (default: the newest) of
        ``exp_dir/checkpoints/last``."""
        if path is not None and os.path.isdir(path):
            return self._restore_orbax(path)
        if path is None:
            step = self.latest_step() if step is None else step
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint under {self._checkpoint_root()}/last")
            path = os.path.join(self._checkpoint_root(), "last",
                                checkpoint_name(step))
        blob = torch.load(path, map_location="cpu", weights_only=False)
        sd = blob["state_dict"]
        self._load_model({k[len("model."):]: v for k, v in sd.items()
                          if k.startswith("model.")}, path)
        opt = blob["optimizer_states"][0]["state"]
        order = range(len(self.params))
        opt_state = {"count": int(opt[0]["step"]) if opt else 0,
                     "mu": self._local([opt[i]["exp_avg"] for i in order]),
                     "nu": self._local([opt[i]["exp_avg_sq"]
                                        for i in order])}
        ema = None
        if self.use_ema:
            ema = {"shadow": self._local([sd["model_ema." + n.replace(".", "")]
                                          for n in self.names]),
                   "num_updates": int(sd["model_ema.num_updates"])}
        acc = blob.get("accumulated_grads")
        return TrainState(step=int(blob["global_step"]), opt_state=opt_state,
                          ema=ema,
                          acc_grads=None if acc is None else self._local(acc),
                          mini_step=int(blob.get("mini_step", 0)))

    def _load_model(self, model_sd: Dict, source: str) -> None:
        """The model's weights and buffers from a whole state_dict."""
        missing = set(self.model.state_dict()) - set(model_sd)
        if missing:
            raise KeyError(f"{source} lacks {sorted(missing)[:5]}")
        params = set(self.names)
        self.model.load_state_dict({k: v for k, v in model_sd.items()
                                    if k not in params}, strict=False)
        self.layout.load_full(model_sd)

    def _local(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole leaves (in ``self.names`` order) as this rank's shards on
        the trainer's device."""
        return self.layout.local_list([t.to(self.device) for t in tensors])

    def _restore_orbax(self, path: str) -> TrainState:
        """Resume from ``lasr_tpu``'s orbax checkpoint of a train state
        (``<root>/last/<step>`` or its ``default``): the step, the
        parameters and BatchNorm statistics, optax's Adam state (its
        ``count``, and ``mu`` / ``nu`` named as the parameters are by
        the weight bridge, in ``self.names`` order), the EMA and, under
        ``optax.MultiSteps``, the accumulated gradient and ``mini_step``.
        ``encoder_scan_layers`` trees are unstacked."""
        item = orbax_item(path)
        if item is None:
            raise FileNotFoundError(f"{path} holds no orbax checkpoint")
        tree = load_tree(item)

        def named(params) -> List[torch.Tensor]:
            sd = flax_to_state_dict({"params": unstack_scan_layers(params)})
            return self._local([sd[n] for n in self.names])

        self._load_model(flax_to_state_dict({
            "params": unstack_scan_layers(tree["params"]),
            "batch_stats": unstack_scan_layers(tree.get("batch_stats")
                                               or {})}), path)
        adam = _find_node(tree["opt_state"], ("count", "mu", "nu"))
        if adam is None:
            raise ValueError(f"{path}: the optimizer state holds no Adam "
                             f"moments (count, mu, nu)")
        multi = _find_node(tree["opt_state"], ("mini_step", "acc_grads"))
        opt_state = {"count": int(adam["count"]), "mu": named(adam["mu"]),
                     "nu": named(adam["nu"])}
        ema = None
        if self.use_ema:
            ema = {"shadow": named(tree["ema"]["shadow"]),
                   "num_updates": int(tree["ema"]["num_updates"])}
        return TrainState(
            step=int(tree["step"]), opt_state=opt_state, ema=ema,
            acc_grads=None if multi is None else named(multi["acc_grads"]),
            mini_step=0 if multi is None else int(multi["mini_step"]))

    # the loop state (epoch, batch index within it) of each saved step, so
    # a resumed run re-enters the same deterministic batch order mid-epoch
    def _loop_state_path(self) -> str:
        return os.path.join(self._checkpoint_root(), "loop_state.json")

    def _write_loop_state(self, step: int, epoch: int, batch_idx: int):
        if self.rank != 0:
            return
        path = self._loop_state_path()
        hist = _read_json(path)
        hist[str(step)] = [epoch, batch_idx]
        hist = dict(sorted(hist.items(), key=lambda kv: int(kv[0]))[-50:])
        _atomic_json(hist, path)

    def _read_loop_state(self, step: int):
        entry = _read_json(self._loop_state_path()).get(str(step))
        return None if entry is None else (int(entry[0]), int(entry[1]))

    # ---- the loop ----

    def fit(self, state: TrainState, train_dataset, valid_dataset=None,
            num_epochs: int = 1, num_workers: int = 4,
            save_checkpoints: bool = True,
            checkpoint_interval_steps: int = 0,
            auto_resume: bool = False,
            valid_interval_epochs: int = 1,
            checkpoint_interval_epochs: int = 1,
            max_wall_secs: float = 0.0,
            wall_t0: Optional[float] = None) -> TrainState:
        """Run the training loop, as ``lasr_tpu``'s ``Trainer.fit``.

        ``auto_resume`` restores the newest checkpoint of ``last/`` and
        its loop state; ``checkpoint_interval_steps`` > 0 also checkpoints
        every N steps mid-epoch; validation and the epoch's checkpoint run
        every ``valid_interval_epochs`` / ``checkpoint_interval_epochs``
        epochs and always after the last; ``max_wall_secs`` > 0
        checkpoints and stops at the first epoch boundary past that many
        seconds since ``wall_t0``.  Under a process group every rank runs
        ``fit`` on its shard of each batch (``dist.layout``), resumes
        rank 0's newest step, stops at rank 0's wall deadline, and waits
        at each checkpoint until rank 0 has written it."""
        start_epoch, start_skip = 0, 0
        main = self.rank == 0
        host, hosts, local_rank, local_world = dist.layout()
        shard = dict(process_index=host, process_count=hosts,
                     local_rank=local_rank, local_world_size=local_world)
        if auto_resume and self.exp_dir:
            latest = self.latest_step()
            latest = dist.broadcast_int(-1 if latest is None else latest,
                                        self.device)
            if latest >= 0:
                state = self.restore_checkpoint(step=latest)
                loop = self._read_loop_state(latest)
                if loop is not None:
                    start_epoch, start_skip = loop
                logging.info("auto-resumed from step %d (epoch %d, "
                             "batch %d)", latest, start_epoch, start_skip)
        metrics_path = None
        if self.exp_dir and main:
            os.makedirs(self.exp_dir, exist_ok=True)
            metrics_path = os.path.join(self.exp_dir, "metrics.jsonl")
        save = save_checkpoints and bool(self.exp_dir)
        pool = None
        if getattr(train_dataset, "device_audio_cache", False):
            if self.world > 1:
                logging.warning("device_audio_cache is single-process only; "
                                "falling back to the wire path")
            else:
                wire = getattr(train_dataset, "wire_dtype", "float32")
                pool = _DeviceAudioPool(
                    len(train_dataset.train_set),
                    train_dataset.max_bucketed_samples(),
                    torch.int16 if wire == "int16" else torch.float32,
                    self.device)

        def checkpoint(valid_metrics, epoch_, batch_idx_):
            self.save_checkpoint(state, valid_metrics)
            self._write_loop_state(state.step, epoch_, batch_idx_)
            if self.world > 1:
                dist.barrier(self.device)

        t0 = time.time()
        wall_t0 = time.time() if wall_t0 is None else wall_t0
        for epoch in range(start_epoch, num_epochs):
            late = bool(max_wall_secs) and epoch > start_epoch \
                and time.time() - wall_t0 > max_wall_secs
            if dist.broadcast_int(int(late), self.device):
                logging.info("wall deadline (%.0fs) reached at epoch %d; "
                             "checkpointing and exiting cleanly",
                             max_wall_secs, epoch)
                if save:
                    checkpoint(None, epoch, 0)
                break
            skip = start_skip if epoch == start_epoch else 0
            batch_idx = skip
            pending = []
            # host time blocked on the next batch vs time in the step (the
            # step ends in its metrics' host copy, so this includes the
            # device's time)
            t_data = t_disp = 0.0
            t_mark = time.perf_counter()
            for batch in train_dataset.batches(
                    shuffle=True, seed=self.seed + epoch,
                    num_workers=num_workers, skip=skip, **shard):
                if pool is not None:
                    batch = pool.strip(batch)
                t_data += time.perf_counter() - t_mark
                t_mark = time.perf_counter()
                if pool is not None:
                    batch = pool.resolve(batch)
                state, metrics = self.train_step(state, batch)
                t_disp += time.perf_counter() - t_mark
                batch_idx += 1
                pending.append((state.step, metrics, batch["n_utts"]))
                if len(pending) >= self.log_interval:
                    self._flush_metrics(pending, epoch, metrics_path, t0,
                                        t_data, t_disp)
                    pending = []
                    t_data = t_disp = 0.0
                if checkpoint_interval_steps and save and \
                        state.step % checkpoint_interval_steps == 0:
                    checkpoint(None, epoch, batch_idx)
                t_mark = time.perf_counter()
            if pending:
                self._flush_metrics(pending, epoch, metrics_path, t0,
                                    t_data, t_disp)
            last_epoch = epoch == num_epochs - 1
            valid_metrics = None
            if valid_dataset is not None and (
                    last_epoch or (epoch + 1) % valid_interval_epochs == 0):
                valid_metrics = self.validate(state, valid_dataset)
                if main:
                    logging.info("epoch %d valid: %s", epoch,
                                 {k: round(v, 4) for k, v in
                                  valid_metrics.items()})
                if metrics_path:
                    _append_line(metrics_path, {
                        "epoch": epoch, "step": state.step,
                        **{"valid_" + k: v
                           for k, v in valid_metrics.items()}})
            if save and (last_epoch
                         or (epoch + 1) % checkpoint_interval_epochs == 0):
                checkpoint(valid_metrics, epoch + 1, 0)
        return state

    def validate(self, state: TrainState, valid_dataset,
                 num_workers: int = 2) -> Dict[str, float]:
        """The mean of each per-batch metric over the dataset (batches
        tagged ``order_pad`` are not scored), EMA weights when
        ``use_ema``; under a process group each rank takes its shard of
        every batch and the metrics are the global batches'."""
        totals: Dict[str, float] = {}
        n_batches = 0
        host, hosts, local_rank, local_world = dist.layout()
        for batch in valid_dataset.batches(
                num_workers=num_workers, process_index=host,
                process_count=hosts, local_rank=local_rank,
                local_world_size=local_world):
            metrics = self.valid_step(state, batch)
            if batch.get("order_pad"):
                continue
            for k, v in metrics.items():
                if k != "n_utts":
                    totals[k] = totals.get(k, 0.0) + v
            n_batches += 1
        return {k: v / max(n_batches, 1) for k, v in totals.items()}

    def _flush_metrics(self, pending, epoch, metrics_path, t0,
                       t_data: float = 0.0, t_disp: float = 0.0):
        step, host, _ = pending[-1]
        host = dict(host)
        utts = sum(n for _, _, n in pending)
        # ctc_cer is computed on the logged steps only (-1 elsewhere; so
        # is grad_norm with acc_grads > 1 over several ranks): a flush
        # whose last step did not compute it reads the newest step that
        # did, or leaves it out (pending holds the steps after update)
        for key in ("ctc_cer", "grad_norm"):
            if host.get(key, 0.0) != -1.0:
                continue
            for s, m, _ in reversed(pending[:-1]):
                if self._logged(s - 1):
                    host[key] = m[key]
                    break
            else:
                host.pop(key, None)
        line = {"epoch": epoch, "step": step,
                "utts_cum": utts, "wall_s": round(time.time() - t0, 2),
                "data_wait_s": round(t_data, 2),
                "dispatch_s": round(t_disp, 2),
                **{k: float(v) for k, v in host.items()}}
        if self.schedule is not None:
            line["lr"] = float(self.schedule(
                max(step // max(self.acc_grads, 1) - 1, 0)))
        if dist.is_main():
            logging.info("train %s", {k: (round(v, 4) if isinstance(v, float)
                                          else v) for k, v in line.items()})
        if metrics_path:
            _append_line(metrics_path, line)
        tb = self._tb_writer()
        if tb is not None:
            for k, v in line.items():
                if isinstance(v, (int, float)) and k not in ("epoch", "step"):
                    tb.add_scalar(k, v, step)
            tb.flush()


def _setup_grid_model(model, grid) -> bool:
    """Fit ``model`` to the grid's pipe and seq axes (``lasr_tpu``'s
    Trainer's mesh checks); returns whether the encoder's time splits over
    the seq ranks."""
    encoder = getattr(model, "encoder", None)
    if grid.pipe_size > 1:
        stages = getattr(encoder, "pipeline_stages", 1)
        if stages % grid.pipe_size:
            raise ValueError(
                f"the grid's pipe axis is {grid.pipe_size} but the model "
                f"has encoder_pipeline_stages={stages}; set the model's "
                f"pipeline stages to a multiple of the pipe axis "
                f"(-pipeline_parallel N sets it to N)")
    if grid.seq_size <= 1:
        return False
    if grid.pipe_size > 1:
        # the time stays whole inside the pipeline stages
        if hasattr(encoder, "act_sharding"):
            encoder.act_sharding = False
        logging.info("pipe+seq grid: encoder activations are not "
                     "time-sharded inside the pipeline stages")
        return False
    if not hasattr(encoder, "act_sharding"):
        logging.warning(
            "the grid has a seq axis of %d but %s has no "
            "encoder_act_sharding field; sequence parallelism is a no-op "
            "for this model and those ranks repeat the same work",
            grid.seq_size, type(model).__name__)
        return False
    encoder.act_sharding = True
    return True


class _ScalarWriter:
    """TensorBoard scalars in one events file under ``logdir``: the
    ``Event`` records ``torch.utils.tensorboard.SummaryWriter`` writes for
    ``add_scalar`` (tensorboard's protos and record framing), without that
    module, whose import loads TensorFlow where it is installed (seconds
    a process) and whose TensorFlow-free switch is process-wide."""

    def __init__(self, logdir: str):
        from tensorboard.summary.writer.record_writer import RecordWriter
        from tensorboard.compat.proto import event_pb2, summary_pb2
        self._event, self._summary = event_pb2.Event, summary_pb2.Summary
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        self._records = RecordWriter(open(os.path.join(logdir, name), "wb"))
        self._write(self._event(wall_time=time.time(),
                                file_version="brain.Event:2"))

    def _write(self, event) -> None:
        self._records.write(event.SerializeToString())

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(self._event(
            wall_time=time.time(), step=int(step),
            summary=self._summary(value=[self._summary.Value(
                tag=tag, simple_value=float(value))])))

    def flush(self) -> None:
        self._records.flush()

    def close(self) -> None:
        self._records.close()


class _DeviceAudioPool:
    """The waves of every dataset row, kept on the trainer's device
    (dataset ``device_audio_cache``): an (n_rows + 1, S_max) tensor in the
    wire dtype whose row n stays zeros (the row padding rows point at).
    The first epoch's batches carry their waves, which ``resolve``
    scatters into the pool at their stable rows; a batch whose rows are
    all pooled loses its wave on the host (``strip``), ships only its row
    indices, and ``resolve`` gathers it on the device.  ``fit`` strips
    and resolves each batch in turn, so a stripped batch's rows were
    scattered by an earlier batch.  Single-process only."""

    def __init__(self, n_rows: int, s_max: int, dtype, device):
        self.pool = torch.zeros((n_rows + 1, s_max), dtype=dtype,
                                device=device)
        self._have = np.zeros(n_rows + 1, dtype=bool)
        self._have[n_rows] = True
        logging.info("device audio pool: %d rows x %d samples (%s, %.1f "
                     "MB)", n_rows, s_max, dtype,
                     self.pool.numel() * self.pool.element_size() / 2 ** 20)

    def strip(self, host_batch: Dict) -> Dict:
        """Host side: drop the wave of a batch whose rows are all pooled
        (and mark the rows of one that carries it)."""
        rows = host_batch.get("wav_rows")
        if rows is None:
            return host_batch
        if self._have[rows].all():
            host_batch = dict(host_batch)
            del host_batch["wav_array"]
        else:
            self._have[rows] = True
        return host_batch

    def resolve(self, batch: Dict) -> Dict:
        """Device side: scatter a carried wave into the pool, or gather a
        stripped batch's wave out of it."""
        if batch.get("wav_rows") is None:
            return batch
        out = dict(batch)
        rows = torch.as_tensor(batch["wav_rows"],
                               device=self.pool.device).long()
        out["wav_rows"] = rows
        if "wav_array" in batch:
            wav = torch.as_tensor(batch["wav_array"], device=self.pool.device)
            self.pool[:, : wav.shape[1]].index_copy_(0, rows,
                                                     wav.to(self.pool.dtype))
            out["wav_array"] = wav
        else:
            out["wav_array"] = self.pool[rows, : batch["wav_S"]]
        return out


def _find_node(tree, keys):
    """The first dict in ``tree`` (an orbax optimizer state: dicts and
    lists) that holds every one of ``keys``, or None."""
    if isinstance(tree, dict):
        if all(k in tree for k in keys):
            return tree
        children = tree.values()
    elif isinstance(tree, list):
        children = tree
    else:
        return None
    for child in children:
        found = _find_node(child, keys)
        if found is not None:
            return found
    return None


def _atomic_save(blob: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def _read_json(path: str) -> Dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _atomic_json(obj: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _append_line(path: str, line: Dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(line) + "\n")
