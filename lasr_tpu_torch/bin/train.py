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
the exact epoch and batch of the newest.

``-fp16 16`` builds the model with ``dtype=torch.bfloat16`` (bf16
compute, float32 parameters, optimizer state and checkpoints), as the JAX
CLI builds it with ``jnp.bfloat16``; ``hparams.yaml`` does not record it.
``-device`` (default ``cuda``) picks the device; without a GPU pass
``-device cpu``.  Flags of features the port lacks raise
``NotImplementedError`` naming their ROADMAP item when set away from their
defaults: ``-num_devices`` > 1, ``-model_parallel``, ``-seq_parallel``,
``-pipeline_parallel`` > 1 and ``-fsdp 1`` (A6).  The model classes the
recipes name train, in either dtype: ``E2E_Conformer_CTC``,
``E2E_Transformer_CTC`` and ``E2E_Transformer_CTC_Online`` (the toy
recipe's ``config.yaml`` and ``config_online.yaml``).
"""

import argparse
import logging
import sys
import time

import yaml

_PROC_T0 = time.time()

# flag -> (its default, the ROADMAP item of the feature it selects)
_UNPORTED = {"model_parallel": (1, "A6"), "seq_parallel": (1, "A6"),
             "pipeline_parallel": (1, "A6"), "fsdp": (0, "A6")}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-exp_dir", default="exp", type=str)
    parser.add_argument("-config", required=True)
    parser.add_argument("-num_devices", default=-1, type=int,
                        help="data-parallel devices; -1 = all local ones "
                             "(the port trains on one device)")
    parser.add_argument("-model_parallel", default=1, type=int,
                        help="tensor parallelism (not ported)")
    parser.add_argument("-seq_parallel", default=1, type=int,
                        help="sequence parallelism (not ported)")
    parser.add_argument("-pipeline_parallel", default=1, type=int,
                        help="pipeline parallelism (not ported)")
    parser.add_argument("-fsdp", default=0, type=int,
                        help="1 = FSDP/ZeRO sharding (not ported)")
    parser.add_argument("-num_epochs", default=50, type=int)
    parser.add_argument("-fp16", default=32, type=int,
                        help="32 = float32 compute; 16 = bfloat16 "
                             "compute (float32 parameters)")
    parser.add_argument("-ema", default=0, type=int,
                        help="1 = keep an EMA shadow of the params")
    parser.add_argument("-acc_grads", default=1, type=int)
    parser.add_argument("-resume_ckpt", default=None, type=str)
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


def refuse_unported(args) -> None:
    """Raise for a flag that selects a feature the port lacks."""
    for flag, (default, item) in _UNPORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"-{flag} {getattr(args, flag)}: not ported (ROADMAP "
                f"{item}); the port trains on one device")
    if args.num_devices > 1:
        raise NotImplementedError(
            f"-num_devices {args.num_devices}: data parallelism is not "
            f"ported (ROADMAP A6)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    refuse_unported(args)

    import torch

    from lasr_tpu_torch import resolve_device
    from lasr_tpu_torch.data.frontend import DeviceFrontend
    from lasr_tpu_torch.train.optimizer import build_optimizer
    from lasr_tpu_torch.train.trainer import Trainer
    from lasr_tpu_torch.utils.registry import BaseConfig

    device = resolve_device(args.device)
    with open(args.config) as f:
        config = yaml.safe_load(f)

    train_data_config = config["train_data_config"]
    valid_data_config = config["valid_data_config"]
    model_config = config["model_config"]
    opt_config = config["opti_config"]
    criterion_config = config["criterion_config"]
    tokenizer_config = config["tokenizer_config"]

    tokenizer = BaseConfig(**tokenizer_config).generateExample()
    # one device: batches pad to no multiple (the JAX CLI pads to its mesh)
    for dc in (train_data_config, valid_data_config):
        dc.setdefault("kwargs", {}).setdefault("batch_pad_multiple", 1)
    train_dataset = BaseConfig(**train_data_config).generateExample(
        tokenizer=tokenizer)
    valid_dataset = BaseConfig(**valid_data_config).generateExample(
        tokenizer=tokenizer)

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
        log_interval=args.log_interval, device=device)

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
                        wall_t0=_PROC_T0)
    logging.info("done at step %d", state.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
