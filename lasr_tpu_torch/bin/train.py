"""Training CLI (counterpart of the JAX package's ``bin/train.py``).

    python -m lasr_tpu_torch.bin.train -config conf/config.yaml \
        -exp_dir exp/run [-num_epochs 50] [-ema 1] [-acc_grads 4] ...

The same flags, defaults and YAML schema: model_config /
opti_config (+ scheduler) / criterion_config / tokenizer_config /
train_data_config / valid_data_config, each a ``{name, kwargs}`` block
(``lasr_tpu.…`` class names resolve onto this package), with ``odim``,
``size`` and ``padding_idx`` injected from the tokenizer.  Writes
``exp_dir/hparams.yaml`` (the four config blocks the decode CLI reads),
``metrics.jsonl`` and ``checkpoints/{last,best}``; with ``-auto_resume 1``
(the default) a run in an ``exp_dir`` that holds checkpoints continues at
the exact epoch and batch of the newest.  ``-resume_ckpt`` names a port
``.ckpt`` or an orbax step directory of ``lasr_tpu``'s Trainer
(``<exp>/checkpoints/last/<step>``): a run trained on a TPU goes on here
from its step, weights, Adam state and EMA.

``-fp16 16`` builds the model with ``dtype=torch.bfloat16`` (bf16
compute, float32 parameters, optimizer state and checkpoints), as the JAX
CLI builds it with ``jnp.bfloat16``; ``hparams.yaml`` does not record it.
``-device`` (default ``cuda``) picks the device; without a GPU pass
``-device cpu``.  The model classes the recipes name train, in either
dtype: ``E2E_Conformer_CTC``, ``E2E_Transformer_CTC`` and
``E2E_Transformer_CTC_Online`` (the toy recipe's ``config.yaml`` and
``config_online.yaml``).

Data parallelism, one process (rank) per device: ``-num_devices N``
trains on N local GPUs, ``-1`` (the default) on every one
(``torch.cuda.device_count()``, as the JAX CLI takes every device), and
more than there are raises; ``-device cpu -num_devices N`` runs N
``gloo`` ranks on the CPU.  Without ``torchrun`` the CLI spawns the ranks
itself; under ``torchrun --nproc_per_node N -m lasr_tpu_torch.bin.train
...`` each process is one rank.  Batches pad to a multiple of the ranks
on a host (the JAX CLI pads to its data axis), a step equals the one-GPU
step on the global batch (``lasr_tpu_torch/parallel/dist.py``), rank 0
writes, and a rank that fails ends the run with a non-zero exit.  At one
rank the group is one process and nothing is communicated.

The (data, pipe, seq, model) grid, as the JAX CLI's mesh:
``-model_parallel M`` makes M ranks a model group that splits the
attention and feed-forward layers, the token embedding and the logits
heads (tensor parallelism, ``parallel/tensor.py``); ``-seq_parallel S``
splits the encoder's time axis over S ranks (sequence parallelism, the
Conformer and Transformer encoders); ``-pipeline_parallel P`` splits the
encoder's blocks into GPipe stages over P ranks (``modules/pipeline.py``)
and sets the model's ``encoder_pipeline_stages`` to P unless the YAML
sets it (to a multiple of P).  ``-num_devices`` counts the data ranks, so
a run has ``num_devices x P x S x M`` ranks (rank r: model index r % M,
seq index (r // M) % S, pipe index (r // (M·S)) % P, data index
r // (M·S·P); ``-num_devices -1`` takes every GPU's worth of them).
``-fsdp 1`` shards the large leaves' parameters, gradients, Adam moments,
accumulated gradient and EMA shadow over the data ranks
(``parallel/sharding.py``).  Checkpoints stay whole reference ``.ckpt``
files, so a run resumes at any layout.
"""

import argparse
import logging
import os
import sys
import time

import yaml

_PROC_T0 = time.time()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-exp_dir", default="exp", type=str)
    parser.add_argument("-config", required=True)
    parser.add_argument("-num_devices", default=-1, type=int,
                        help="data-parallel ranks (each with "
                             "-model_parallel devices); -1 = every local "
                             "GPU (one data rank on the CPU)")
    parser.add_argument("-model_parallel", default=1, type=int,
                        help="tensor-parallel ranks of a model group")
    parser.add_argument("-seq_parallel", default=1, type=int,
                        help="sequence-parallel ranks: the encoder's time "
                             "axis splits over them")
    parser.add_argument("-pipeline_parallel", default=1, type=int,
                        help="pipeline ranks: GPipe stages of the "
                             "encoder's blocks (sets the model's "
                             "encoder_pipeline_stages unless the YAML "
                             "does)")
    parser.add_argument("-fsdp", default=0, type=int,
                        help="1 = FSDP/ZeRO: shard params, gradients, "
                             "optimizer moments, the grad accumulator and "
                             "the EMA over the data ranks")
    parser.add_argument("-num_epochs", default=50, type=int)
    parser.add_argument("-fp16", default=32, type=int,
                        help="32 = float32 compute; 16 = bfloat16 "
                             "compute (float32 parameters)")
    parser.add_argument("-ema", default=0, type=int,
                        help="1 = keep an EMA shadow of the params")
    parser.add_argument("-acc_grads", default=1, type=int)
    parser.add_argument("-resume_ckpt", default=None, type=str,
                        help="a port .ckpt, or an orbax step directory "
                             "of lasr_tpu (<exp>/checkpoints/last/<step>)")
    parser.add_argument("-auto_resume", default=1, type=int,
                        help="restore the newest checkpoint in exp_dir and "
                             "continue at the exact epoch/batch (0 "
                             "disables)")
    parser.add_argument("-checkpoint_interval_steps", default=0, type=int,
                        help="additionally checkpoint mid-epoch every N "
                             "steps (0 = per-epoch only)")
    parser.add_argument("-valid_interval_epochs", default=1, type=int,
                        help="run validation every N epochs (always on the "
                             "final epoch)")
    parser.add_argument("-checkpoint_interval_epochs", default=1, type=int,
                        help="save the per-epoch checkpoint every N epochs "
                             "(always on the final epoch)")
    parser.add_argument("-max_wall_secs", default=0, type=float,
                        help="checkpoint and exit cleanly at the first "
                             "epoch boundary once the process is this old "
                             "(0 = off); pair with -auto_resume")
    parser.add_argument("-num_workers", default=8, type=int)
    parser.add_argument("-seed", default=0, type=int)
    parser.add_argument("-log_interval", default=50, type=int)
    parser.add_argument("-fast_rng", default=1, type=int,
                        help="accepted for the JAX CLI's flag surface, no "
                             "effect: it selects JAX's PRNG, and the port "
                             "draws from torch.Generators keyed on "
                             "(seed, step)")
    parser.add_argument("-device", default="cuda", type=str,
                        help="torch device to train on (cuda or cpu)")
    return parser


def _log_config(rank: int) -> None:
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(message)s")


def replicas(args) -> int:
    """The ranks of a data index: ``-pipeline_parallel`` x
    ``-seq_parallel`` x ``-model_parallel`` (each checked >= 1)."""
    out = 1
    for flag in ("pipeline_parallel", "seq_parallel", "model_parallel"):
        k = getattr(args, flag)
        if k < 1:
            raise ValueError(f"-{flag} {k}: expected a count >= 1")
        out *= k
    return out


def num_ranks(args) -> int:
    """The ranks the grid's flags ask for on this host: data ranks times
    ``replicas``, -1 data ranks meaning every local GPU's worth (one data
    rank on the CPU); more GPUs than there are raise."""
    import torch

    from lasr_tpu_torch import resolve_device
    device = resolve_device(args.device)
    n, mp = args.num_devices, replicas(args)
    if n == 0 or n < -1:
        raise ValueError(f"-num_devices {n}: expected -1 or a count >= 1")
    if device.type != "cuda":
        return (1 if n == -1 else n) * mp
    count = torch.cuda.device_count()
    n = count // mp if n == -1 else n
    if n < 1 or n * mp > count:
        raise ValueError(f"-num_devices {n} x {mp} ranks of a data index "
                         f"exceeds the {count} available GPUs")
    n *= mp
    if n > 1 and device.index is not None:
        raise ValueError(f"-device {args.device}: with -num_devices {n} "
                         f"rank i takes cuda:i; pass -device cuda")
    return n


def main(argv=None):
    args = build_parser().parse_args(argv)
    from lasr_tpu_torch.parallel import dist
    if dist.launched_by_torchrun():
        _log_config(int(os.environ["RANK"]))
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ["WORLD_SIZE"]))
        if args.num_devices != -1 and \
                args.num_devices * replicas(args) != local:
            raise ValueError(f"-num_devices {args.num_devices} x "
                             f"{replicas(args)} ranks of a data index: "
                             f"torchrun started {local} ranks on this host")
        return run(args)
    _log_config(0)
    n = num_ranks(args)
    if n == 1:
        return run(args)
    logging.info("spawning %d ranks", n)
    dist.spawn(_spawned_rank, n, (args, _PROC_T0))
    return 0


def _spawned_rank(rendezvous, args, wall_t0):
    _log_config(rendezvous.rank)
    run(args, rendezvous, wall_t0=wall_t0)


def run(args, rendezvous=None, wall_t0=None) -> int:
    """One rank's training run: join the process group (``spawn``'s
    ``rendezvous``, else ``torchrun``'s environment, else a group of one)
    on the rank's device (``-device``; for CUDA the rank's local GPU),
    ``build`` and ``fit``, leave the group.  A caller with other needs
    (two ``gloo`` ranks sharing one card) calls ``dist.init``, ``build``
    and ``fit`` itself."""
    import torch

    from lasr_tpu_torch import resolve_device
    from lasr_tpu_torch.parallel import dist

    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        local = (rendezvous.rank if rendezvous is not None
                 else int(os.environ.get("LOCAL_RANK", 0)))
        device = torch.device("cuda", local)
    if device.type == "cpu" and rendezvous is not None:
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // rendezvous.world_size))
    backend = dist.init(device, rendezvous=rendezvous,
                        model_parallel=args.model_parallel,
                        seq_parallel=args.seq_parallel,
                        pipeline_parallel=args.pipeline_parallel)
    try:
        logging.info("data parallel: backend %s, world size %d, device %s; "
                     "%d data x %d model ranks, fsdp %d; %d pipe x %d seq "
                     "ranks", backend, dist.world_size(), device,
                     dist.data_size(), dist.model_size(), args.fsdp,
                     dist.pipe_size(), dist.seq_size())
        fit(args, *build(args, device),
            wall_t0=_PROC_T0 if wall_t0 is None else wall_t0)
        return 0
    finally:
        dist.shutdown()


def build(args, device):
    """The run's (trainer, state, train dataset, valid dataset) on
    ``device``, its data checked and ``hparams.yaml`` written, under the
    process group the caller joined."""
    import torch

    from lasr_tpu_torch.data.frontend import DeviceFrontend
    from lasr_tpu_torch.parallel import dist
    from lasr_tpu_torch.train.optimizer import build_optimizer
    from lasr_tpu_torch.train.trainer import Trainer
    from lasr_tpu_torch.utils.registry import BaseConfig

    with open(args.config) as f:
        config = yaml.safe_load(f)

    train_data_config = config["train_data_config"]
    valid_data_config = config["valid_data_config"]
    model_config = config["model_config"]
    opt_config = config["opti_config"]
    criterion_config = config["criterion_config"]
    tokenizer_config = config["tokenizer_config"]

    tokenizer = BaseConfig(**tokenizer_config).generateExample()
    # batch rows divide over the host's data ranks (the JAX CLI pads to
    # its data axis)
    local_world = dist.layout()[3]
    for dc in (train_data_config, valid_data_config):
        dc.setdefault("kwargs", {}).setdefault("batch_pad_multiple",
                                               local_world)
    train_dataset = BaseConfig(**train_data_config).generateExample(
        tokenizer=tokenizer)
    valid_dataset = BaseConfig(**valid_data_config).generateExample(
        tokenizer=tokenizer)

    if args.pipeline_parallel > 1:
        # stage the encoder unless the YAML did (the Trainer checks that
        # the stages divide over the pipe ranks)
        model_config["kwargs"].setdefault("encoder_pipeline_stages",
                                          args.pipeline_parallel)

    output_dim = tokenizer.dict_size()
    if "odim" in model_config["kwargs"]:
        model_config["kwargs"]["odim"] = output_dim
    if "size" in criterion_config["kwargs"]:
        criterion_config["kwargs"]["size"] = output_dim
    if "padding_idx" in criterion_config["kwargs"]:
        criterion_config["kwargs"]["padding_idx"] = tokenizer.ID_VALUE_IGNORE

    # the initial weights come from -seed
    torch.manual_seed(args.seed)
    dtype = torch.bfloat16 if args.fp16 == 16 else torch.float32
    model = BaseConfig(**model_config).generateExample(dtype=dtype,
                                                       device=device)
    criterion = BaseConfig(**criterion_config).generateExample()
    optimizer, schedule = build_optimizer(opt_config)
    frontend = DeviceFrontend(train_dataset.audio_trans)

    trainer = Trainer(
        model, criterion, optimizer, frontend, tokenizer=tokenizer,
        exp_dir=args.exp_dir, schedule=schedule, use_ema=args.ema == 1,
        acc_grads=args.acc_grads, seed=args.seed,
        log_interval=args.log_interval, device=device, fsdp=args.fsdp == 1)

    logging.info("loading + checking data")
    train_dataset.load_check_data()
    valid_dataset.load_check_data()
    logging.info("train batches: %d, valid batches: %d",
                 len(train_dataset.batch_indices()),
                 len(valid_dataset.batch_indices()))
    state = trainer.init_state()
    logging.info("model parameters: %.2fM", trainer.param_count() / 1e6)

    trainer.save_hparams({
        "model_config": model_config,
        "criterion_config": criterion_config,
        "optim_config": opt_config,
        "tokenizer_config": tokenizer_config,
    })

    if args.resume_ckpt:
        state = trainer.restore_checkpoint(path=args.resume_ckpt)
        logging.info("resumed from %s at step %d", args.resume_ckpt,
                     state.step)
    return trainer, state, train_dataset, valid_dataset


def fit(args, trainer, state, train_dataset, valid_dataset, wall_t0=None):
    """``Trainer.fit`` with the flags' settings; returns the final
    state."""
    state = trainer.fit(state, train_dataset, valid_dataset,
                        num_epochs=args.num_epochs,
                        num_workers=args.num_workers,
                        auto_resume=bool(args.auto_resume)
                        and not args.resume_ckpt,
                        checkpoint_interval_steps=
                        args.checkpoint_interval_steps,
                        valid_interval_epochs=args.valid_interval_epochs,
                        checkpoint_interval_epochs=
                        args.checkpoint_interval_epochs,
                        max_wall_secs=args.max_wall_secs,
                        wall_t0=wall_t0)
    logging.info("done at step %d", state.step)
    return state


if __name__ == "__main__":
    sys.exit(main())
