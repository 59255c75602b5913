"""Weight bridge and reference checkpoint loading (torch-only counterpart
of ``lasr_tpu/utils/torch_compat.py``).

``flax_to_state_dict`` is the inverse of ``torch_compat._map_leaf``: it
turns the JAX model's ``{"params", "batch_stats"}`` tree (nested dicts of
numpy arrays) into the reference-named torch ``state_dict``:

  encoder/embed/Conv_{k}/*      → encoder.embed.conv.{2k}.*
  encoder/embed/Dense_0/*       → encoder.embed.out.0.*
  {encoder,decoder}/layers_N/*  → {encoder.encoders,decoder.decoders}.N.*
  {encoder,decoder}/embed_tok/embedding
                                → {encoder,decoder}.embed.0.weight
  feed_forward/Dense_{0,1}      → feed_forward.w_{1,2}
  ctc/Dense_0/*                 → ctc.1.*
  */scale                       → */weight (norms)
  other leaves (pos_bias_u/v, src_att_bias, embed_linear/*, embed_norm/*,
  the scaled encoding's embed/pos_enc/alpha and embed_pos/alpha)
                                → the same names
  batch_stats */{mean,var}      → */running_{mean,var} (+ num_batches_tracked)

Layouts: Linear (in,out) → (out,in); Conv2d (kh,kw,in,out) →
(out,in,kh,kw); Conv1d (k,in/g,out) → (out,in/g,k), grouped or not; a
``ConvTranspose_k`` kernel (kh,kw,in,out) → ``ConvTranspose2d``'s
(in,out,kh,kw) flipped in both spatial axes (Flax correlates with the
kernel as it is, torch with it flipped); a 3-D ``DenseGeneral`` kernel
(in,out,steps) → (steps,out,in).  The auxiliary modules (``modules.vgg``,
``fillier``, ``wav2vec``, ``ConvPosEmbedding``, ``Conv2dUpsampling``)
keep Flax's layer names, so these rules carry them as they are, and
``lasr_tpu``'s ``torch_to_flax`` carries them back (all but the
transpose convs, which it reads as plain convs).

``state_dict_to_numpy`` is the step back: a trained state_dict as numpy
arrays, which ``lasr_tpu``'s ``torch_to_flax`` reads.

``load_reference_checkpoint`` reads a lighting-asr ``.pt``/``.ckpt`` file,
or averages a directory of checkpoints, splits the Lightning ``model.`` /
``model_ema.`` prefixes and prefers the EMA shadow.  A directory is a
checkpoints root of the port's ``Trainer`` (``…/checkpoints``, whose
``last/`` or ``best/`` the ``choose`` argument selects, or one of those
two): its ``avg`` highest steps are averaged, as ``lasr_tpu``'s
``average_checkpoints`` picks them; or a directory of other ``.ckpt``
files, averaged with the reference's filename-sort rule.

``lasr_tpu``'s own checkpoints are orbax directories (``utils.ocdbt``
reads them): a checkpoints root ``<root>/{last,best}/<step>/default``, of
which ``read_orbax`` averages the ``avg`` highest steps of ``choose``'s
manager as ``lasr_tpu``'s ``average_checkpoints`` does (the best manager
keeps only its best steps), or one bare checkpoint directory.
``orbax_variables`` takes the EMA shadow where there is one and names an
``encoder_scan_layers`` tree's stacked blocks ``layers_{i}``.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lasr_tpu_torch.utils.ocdbt import is_checkpoint_dir, load_tree

CHECKPOINT_NAME = re.compile(r"step-(\d+)\.ckpt")


def checkpoint_name(step: int) -> str:
    """The port's checkpoint file name: ``step-<step>.ckpt`` with the step
    zero-padded to 9 digits, so the reference's filename sort is the step
    order."""
    return f"step-{step:09d}.ckpt"


def checkpoint_steps(directory: str) -> Dict[int, str]:
    """{step: file name} of the port's checkpoints in ``directory``."""
    try:
        names = os.listdir(directory)
    except OSError:
        return {}
    return {int(m.group(1)): n for n in names
            if (m := CHECKPOINT_NAME.fullmatch(n))}


def _numpy(leaf) -> np.ndarray:
    """A tree leaf (numpy, JAX or torch) as numpy; a torch bfloat16 leaf,
    which numpy lacks, widened to float32."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_path(path: Tuple[str, ...]):
    out = []
    i = 0
    while i < len(path):
        p = path[i]
        nxt = path[i + 1] if i + 1 < len(path) else None
        if p.startswith("layers_"):
            out += ["encoders" if out[:1] == ["encoder"] else "decoders",
                    p[len("layers_"):]]
        elif p == "embed" and nxt is not None and nxt.startswith("Conv_"):
            out += ["embed", "conv", str(2 * int(nxt[len("Conv_"):]))]
            i += 1
        elif p == "embed" and nxt == "Dense_0":
            out += ["embed", "out", "0"]
            i += 1
        elif p == "embed_tok":
            out += ["embed", "0"]
        elif p == "feed_forward" and nxt in ("Dense_0", "Dense_1"):
            out += [p, "w_1" if nxt == "Dense_0" else "w_2"]
            i += 1
        elif p == "ctc" and nxt == "Dense_0":
            out += ["ctc", "1"]
            i += 1
        else:
            out.append(p)
        i += 1
    return out


def flax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree (numpy leaves) → reference-
    named torch state_dict of float32 tensors."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables.get("params", {})):
        arr = _numpy(arr)
        names = _torch_path(path)
        leaf = names[-1]
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4 and names[-2].startswith("ConvTranspose_"):
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1).copy()
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 3:
                arr = arr.transpose(2, 1, 0)
            names[-1] = "weight"
        elif leaf in ("scale", "embedding"):
            names[-1] = "weight"
        sd[".".join(names)] = torch.tensor(arr)
    for path, arr in _flatten(variables.get("batch_stats", {})):
        names = _torch_path(path)
        names[-1] = {"mean": "running_mean", "var": "running_var"}[names[-1]]
        sd[".".join(names)] = torch.tensor(_numpy(arr))
        if names[-1] == "running_mean":
            sd[".".join(names[:-1] + ["num_batches_tracked"])] = \
                torch.tensor(0, dtype=torch.int64)
    return sd


def _flax_path(names):
    """The inverse of ``_torch_path``."""
    out, i = [], 0
    while i < len(names):
        p = names[i]
        nxt = names[i + 1] if i + 1 < len(names) else None
        step = 2
        if p in ("encoders", "decoders"):
            out.append(f"layers_{nxt}")
        elif p == "embed" and nxt == "conv":
            out += ["embed", f"Conv_{int(names[i + 2]) // 2}"]
            step = 3
        elif p == "embed" and nxt == "out":
            out += ["embed", "Dense_0"]
            step = 3
        elif p == "embed" and nxt == "0":
            out.append("embed_tok")
        elif p == "feed_forward" and nxt in ("w_1", "w_2"):
            out += [p, "Dense_0" if nxt == "w_1" else "Dense_1"]
        elif p == "ctc" and nxt == "1":
            out += ["ctc", "Dense_0"]
        else:
            out.append(p)
            step = 1
        i += step
    return out


def _insert(tree: Dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def model_to_flax(model: torch.nn.Module, tensors: Optional[Dict] = None
                  ) -> Dict:
    """The inverse of ``flax_to_state_dict`` for a port model:
    ``{"params", "batch_stats"}`` in ``lasr_tpu``'s names and layouts,
    numpy leaves, from the model's parameters and BatchNorm running
    statistics, or from ``tensors`` named as its parameters (Adam moments,
    an EMA shadow; then ``batch_stats`` is empty).  Each weight's module
    type names it: ``embedding``, ``scale`` (norms) or ``kernel``.

    No entry point of the port calls it: it exists so that a port model's
    state can be written as ``lasr_tpu``'s tree by ``utils.ocdbt.save_tree``
    (how ``chip_smoke.py`` makes a full-width orbax checkpoints root on a
    machine without orbax, and how the tests write one)."""
    from torch import nn
    from torch.nn.modules.batchnorm import _NormBase
    values = dict(model.named_parameters()) if tensors is None else tensors
    out: Dict = {"params": {}, "batch_stats": {}}
    for prefix, module in model.named_modules():
        names = prefix.split(".") if prefix else []
        for leaf, _ in module.named_parameters(recurse=False):
            name = ".".join(names + [leaf])
            if name not in values:
                continue
            arr = values[name].detach().cpu()
            if leaf == "weight":
                if isinstance(module, nn.Embedding):
                    leaf = "embedding"
                elif isinstance(module, (nn.LayerNorm, _NormBase)):
                    leaf = "scale"
                elif isinstance(module, nn.ConvTranspose2d):
                    leaf, arr = "kernel", arr.permute(2, 3, 0, 1).flip(0, 1)
                else:
                    leaf = "kernel"
                    arr = {2: lambda a: a.t(),
                           3: lambda a: a.permute(2, 1, 0),
                           4: lambda a: a.permute(2, 3, 1, 0)}[arr.ndim](arr)
            _insert(out["params"], _flax_path(names) + [leaf],
                    arr.contiguous().numpy())
        if tensors is None and isinstance(module, _NormBase) \
                and module.track_running_stats:
            for buf, leaf in (("running_mean", "mean"), ("running_var",
                                                         "var")):
                _insert(out["batch_stats"], _flax_path(names) + [leaf],
                        getattr(module, buf).detach().cpu().numpy())
    return out


_GATES = {"lstm": "ifgo", "gru": "rzn"}


def _cell_state_dict(cell, typ: str, prefix: str, suffix: str = ""):
    """One Flax ``OptimizedLSTMCell`` / ``GRUCell`` → torch's
    ``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh`` (gates stacked
    in torch's order).  Flax splits each gate into an input-side and a
    hidden-side Dense: the LSTM's biases sit on the hidden side, the
    GRU's on the input side except ``hn``'s."""
    def kernel(name):
        return _numpy(cell[name]["kernel"]).T

    def bias(name, like):
        b = cell[name].get("bias")
        return np.zeros(like.shape[0], like.dtype) if b is None \
            else _numpy(b)

    gates = _GATES[typ]
    w_ih = [kernel("i" + g) for g in gates]
    w_hh = [kernel("h" + g) for g in gates]
    out = {"weight_ih": np.concatenate(w_ih),
           "weight_hh": np.concatenate(w_hh),
           "bias_ih": np.concatenate([bias("i" + g, w)
                                      for g, w in zip(gates, w_ih)]),
           "bias_hh": np.concatenate([bias("h" + g, w)
                                      for g, w in zip(gates, w_hh)])}
    return {f"{prefix}{k}{suffix}": torch.tensor(v) for k, v in out.items()}


def rnnlm_flax_to_state_dict(params, typ: str = "lstm"
                             ) -> Dict[str, torch.Tensor]:
    """``lasr_tpu``'s ``RNNCellStack`` params (numpy leaves) → the state
    dict of ``modules.rnn.RNNCellStack``: ``embed`` (an Embed table or a
    Dense), ``cell_N`` → ``rnn.N.*`` (four Flax leaves a gate group
    become one torch tensor), ``lo``."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    embed = params["embed"]
    if "embedding" in embed:
        sd["embed.weight"] = torch.tensor(_numpy(embed["embedding"]))
    else:
        sd["embed.weight"] = torch.tensor(_numpy(embed["kernel"]).T)
        sd["embed.bias"] = torch.tensor(_numpy(embed["bias"]))
    n = sum(1 for k in params if k.startswith("cell_"))
    for i in range(n):
        sd.update(_cell_state_dict(params[f"cell_{i}"], typ, f"rnn.{i}."))
    sd["lo.weight"] = torch.tensor(_numpy(params["lo"]["kernel"]).T)
    sd["lo.bias"] = torch.tensor(_numpy(params["lo"]["bias"]))
    return sd


def lstm_stack_flax_to_state_dict(params, bidirectional: bool = False
                                  ) -> Dict[str, torch.Tensor]:
    """``lasr_tpu``'s ``LSTMStack`` params → ``modules.rnn.LSTMStack``'s
    state dict.  Flax names the cells ``OptimizedLSTMCell_k`` in creation
    order: layer i's forward cell, then (bidirectional) its backward
    one."""
    params = params.get("params", params)
    per_layer = 2 if bidirectional else 1
    n = sum(1 for k in params if k.startswith("OptimizedLSTMCell_"))
    sd: Dict[str, torch.Tensor] = {}
    for k in range(n):
        layer, direction = divmod(k, per_layer)
        sd.update(_cell_state_dict(
            params[f"OptimizedLSTMCell_{k}"], "lstm", f"layers.{layer}.",
            "_l0" + ("_reverse" if direction else "")))
    return sd


def state_dict_to_numpy(state_dict: Dict) -> Dict[str, np.ndarray]:
    """A reference-named state_dict (after training: with its BatchNorm
    running statistics) as numpy arrays on the host, the form
    ``lasr_tpu.utils.torch_compat.torch_to_flax`` reads."""
    return {k: v.detach().cpu().numpy() for k, v in state_dict.items()}


def split_lightning_state_dict(state_dict: Dict) -> Dict[str, Dict]:
    """Split 'model.xxx' / 'model_ema.xxx' prefixes into sub-dicts."""
    out: Dict[str, Dict] = {}
    for k, v in state_dict.items():
        head, _, rest = k.partition(".")
        out.setdefault(head, {})[rest] = v
    return out


def _model_state(state: Dict, prefer_ema: bool = True) -> Dict:
    """The model's state_dict from a Lightning one (EMA shadow preferred:
    LitEma keys are the model's names with '.' removed), or ``state``
    unchanged when it has no ``model.`` prefix."""
    groups = split_lightning_state_dict(state)
    if "model" not in groups:
        return state
    model_sd = groups["model"]
    if prefer_ema and "model_ema" in groups:
        flat_names = {k.replace(".", ""): k for k in model_sd}
        for ema_key, v in groups["model_ema"].items():
            if ema_key in flat_names:
                model_sd[flat_names[ema_key]] = v
    return model_sd


def _read(path: str) -> Dict:
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return blob.get("state_dict", blob)


def average_reference_checkpoints(path: str, choose: str = "best",
                                  avg: int = 10):
    """Average the ``*.ckpt`` files under ``path``: filename sort, reversed
    for ``choose='last'``, the first ``avg`` summed and divided by the
    number found (integer tensors with ``//``).  Returns
    ``(state_dict, chosen_filenames)``."""
    names = sorted((n for n in os.listdir(path) if n.endswith(".ckpt")),
                   reverse=(choose == "last"))[:avg]
    if not names:
        raise FileNotFoundError(f"no .ckpt files under {path}")
    total = None
    for name in names:
        state = _read(os.path.join(path, name))
        if total is None:
            total = {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in state.items()}
        else:
            for k in total:
                total[k] += state[k]
    for k in total:
        if torch.is_tensor(total[k]) and not torch.is_floating_point(total[k]):
            total[k] //= len(names)
        else:
            total[k] /= len(names)
    return total, names


def average_port_checkpoints(path: str, avg: int = 1):
    """Average the ``avg`` highest steps of the port's checkpoints under
    ``path``: float entries (weights, BatchNorm statistics, the EMA) as
    float64 means cast back to their dtype, integer entries the newest
    checkpoint's.  Returns ``(state_dict, chosen_filenames)``."""
    steps = checkpoint_steps(path)
    names = [steps[s] for s in sorted(steps, reverse=True)[:avg]]
    if not names:
        raise FileNotFoundError(f"no checkpoints under {path}")
    def floats(v):
        return torch.is_tensor(v) and torch.is_floating_point(v)

    total, dtypes = None, None
    for name in names:
        state = _read(os.path.join(path, name))
        if total is None:
            dtypes = {k: v.dtype for k, v in state.items() if floats(v)}
            total = {k: v.double() if floats(v) else v
                     for k, v in state.items()}
        else:
            for k in dtypes:
                total[k] += state[k].double()
    return {k: (v / len(names)).to(dtypes[k]) if k in dtypes else v
            for k, v in total.items()}, names


def orbax_item(path: str) -> Optional[str]:
    """The orbax checkpoint directory at ``path`` (a bare one, or a
    manager step holding ``default/``), or None."""
    for item in (path, os.path.join(path, "default")):
        if is_checkpoint_dir(item):
            return item
    return None


def orbax_steps(directory: str) -> Dict[int, str]:
    """{step: checkpoint directory} of an orbax ``CheckpointManager``
    directory: its numeric step directories (orbax's unfinished
    ``<step>.orbax-checkpoint-tmp-*`` ones are not numeric)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return {}
    return {int(n): item for n in names if n.isdigit()
            and (item := orbax_item(os.path.join(directory, n)))}


AVERAGED = ("params", "ema", "batch_stats")


def average_orbax_checkpoints(directory: str, avg: int = 1):
    """The ``params`` / ``ema`` / ``batch_stats`` trees averaged over the
    ``avg`` highest steps of an orbax manager directory, as ``lasr_tpu``'s
    ``average_checkpoints``: float leaves as float64 sums, newest step
    first, divided and cast back to their dtype; other leaves the newest
    step's.  Returns ``(tree, chosen_steps)``."""
    steps = orbax_steps(directory)
    chosen = sorted(steps, reverse=True)[:avg]
    if not chosen:
        raise FileNotFoundError(f"no orbax checkpoints under {directory}")
    total = None
    for step in chosen:
        tree = load_tree(steps[step], top=AVERAGED)
        leaves = dict(_flatten({k: v for k, v in tree.items() if v}))
        if total is None:
            dtypes = {p: t.dtype for p, t in leaves.items()
                      if torch.is_floating_point(t)}
            total = {p: t.double() if p in dtypes else t
                     for p, t in leaves.items()}
        else:
            for p in dtypes:
                total[p] += leaves[p].double()
    out: Dict = {}
    for path, leaf in total.items():
        _insert(out, path, (leaf / len(chosen)).to(dtypes[path])
                if path in dtypes else leaf)
    return out, chosen


def read_orbax(path: str, choose: str = "last", avg: int = 1
               ) -> Optional[Dict]:
    """The tree of a bare orbax checkpoint directory, or the average of
    the ``avg`` highest steps of a checkpoints root's ``choose`` manager
    (or of ``path`` itself when it is a manager directory); None when
    ``path`` holds no orbax checkpoint."""
    item = orbax_item(path)
    if item is not None:
        return load_tree(item, top=AVERAGED)
    for directory in (os.path.join(path, choose), path):
        if orbax_steps(directory):
            tree, chosen = average_orbax_checkpoints(directory, avg)
            logging.info("averaged orbax checkpoints of %s: steps %s",
                         directory, chosen)
            return tree
    return None


def unstack_scan_layers(tree):
    """``encoder_scan_layers`` stacks the Conformer blocks' leaves
    ``[num_blocks, …]`` under ``layers/block`` (``lasr_tpu/modules/
    conformer.py``); return the tree with them as ``layers_{i}``.  A
    pipelined encoder's ``pipe_stages`` tree raises: pipeline parallelism
    is not ported (ROADMAP A8)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "pipe_stages":
            raise NotImplementedError(
                "a pipelined encoder's checkpoint (encoder_pipeline_stages "
                "> 1): pipeline parallelism is not ported (ROADMAP A8)")
        if k == "layers" and isinstance(v, dict) and set(v) == {"block"}:
            leaves = list(_flatten(v["block"]))
            for i in range(len(leaves[0][1])):
                for path, leaf in leaves:
                    _insert(out, (f"layers_{i}",) + path, leaf[i])
        else:
            out[k] = unstack_scan_layers(v)
    return out


def orbax_variables(tree: Dict) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)`` to decode with from an orbax train-state
    tree: the EMA shadow where there is one (as ``lasr_tpu``'s
    ``load_averaged_params``), the scanned blocks unstacked."""
    params = tree["ema"]["shadow"] if tree.get("ema") else tree["params"]
    return (unstack_scan_layers(params),
            unstack_scan_layers(tree.get("batch_stats") or {}))


def load_averaged_state_dict(path: str, choose: str = "last",
                             avg: int = 1) -> Dict:
    """The Lightning state_dict of a checkpoint file, or the average of a
    directory's checkpoints (see the module docstring for which)."""
    if os.path.isfile(path):
        return _read(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    tree = read_orbax(path, choose, avg)
    if tree is not None:
        params, batch_stats = orbax_variables(tree)
        return flax_to_state_dict({"params": params,
                                   "batch_stats": batch_stats})
    sub = os.path.join(path, choose)
    directory = sub if os.path.isdir(sub) else path
    ckpts = [n for n in os.listdir(directory) if n.endswith(".ckpt")]
    if ckpts and len(checkpoint_steps(directory)) == len(ckpts):
        state, chosen = average_port_checkpoints(directory, avg)
    else:
        state, chosen = average_reference_checkpoints(directory, choose, avg)
    logging.info("averaged checkpoints of %s: %s", directory, chosen)
    return state


def load_reference_checkpoint(path: str, choose: str = "last", avg: int = 1,
                              prefer_ema: bool = True) -> Dict:
    """Model state_dict from a checkpoint file or the average of a
    directory's checkpoints, EMA shadow preferred."""
    return _model_state(load_averaged_state_dict(path, choose, avg),
                        prefer_ema)


def load_model_weights(model: torch.nn.Module, state_dict: Dict) -> None:
    """Load a reference-named state_dict strictly; only BatchNorm's
    ``num_batches_tracked`` counters may be absent."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"state_dict mismatch: missing={sorted(missing)} "
                         f"unexpected={sorted(unexpected)}")
