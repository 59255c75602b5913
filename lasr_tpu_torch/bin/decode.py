"""Decoding CLI (counterpart of the JAX package's ``bin/decode.py``).

    python -m lasr_tpu_torch.bin.decode -train_config exp/run/hparams.yaml \
        -decode_config conf/decode.yaml -model_path exp/run/checkpoints \
        -choose last -avg 10 -output_file exp/run/decode.txt

Loads the training ``hparams.yaml``, rebuilds tokenizer and model, averages
the ``-avg`` newest (``-choose last``) or best (``-choose best``)
checkpoints of a checkpoints root (EMA shadow preferred; a single
``.ckpt``/``.pt`` file, a directory of reference ``.ckpt`` files or an
orbax checkpoint works too), reads the test set with ``AudioDataSet`` and decodes it in batches
of ``-batch`` utterances with the decode config's ``decode_method``,
the JAX CLI's set (``decode.dispatch``): ``ctc_att`` (joint
CTC/attention beam search, with RNNLM shallow fusion, ``nbest`` and
long-form decoding), ``ctc_att_online`` (its streaming form, for
``E2E_Transformer_CTC_Online``), ``ctc_greedy``, ``ctc_bs``,
``ctc_kenlm`` / ``ctc_kenlm_lexcoin`` and ``wfst``.  Prints
``id/ref/hyp/dis`` per utterance, the total WER (as ``Totol WER is …``,
the JAX CLI's spelling), the alignment summary and an RTF line of JSON;
writes ``<hyp> (<id>)`` lines to ``-output_file`` and, with ``nbest`` >
1, ``{id}-{rank} {score:.4f} {text}`` lines to ``-output_file.nbest``.
``-model_path`` may be ``lasr_tpu``'s orbax checkpoints root
(``<exp>/checkpoints``), averaged as the JAX CLI averages it, and the
LM checkpoint (``lm_path``) an orbax directory or root of ``lasr_tpu`` as
well as a ``.pt``/``.ckpt`` state_dict (``decode.lm``).  ``-device``
(default ``cuda``) picks the device.
"""

import argparse
import contextlib
import json
import logging
import sys
import time

import numpy as np
import yaml


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-model_path", required=True,
                        help="checkpoints root (…/checkpoints), one of its "
                             "last/ best/ directories, or a checkpoint file")
    parser.add_argument("-train_config", required=True,
                        help="hparams.yaml written by the train CLI")
    parser.add_argument("-decode_config", required=True)
    parser.add_argument("-output_file", required=True)
    parser.add_argument("-avg", type=int, default=10)
    parser.add_argument("-choose", type=str, default="best")
    parser.add_argument("-batch", type=int, default=8,
                        help="utterances decoded per device batch")
    parser.add_argument("-device", default="cuda", type=str,
                        help="torch device to decode on (cuda or cpu)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    import torch

    from lasr_tpu_torch import resolve_device
    from lasr_tpu_torch.data.frontend import DeviceFrontend
    from lasr_tpu_torch.decode.dispatch import DecodeMethod
    from lasr_tpu_torch.utils.registry import BaseConfig
    from lasr_tpu_torch.utils.text import ErrorRateAccumulator
    from lasr_tpu_torch.utils.weights import (load_model_weights,
                                              load_reference_checkpoint)

    device = resolve_device(args.device)
    with open(args.train_config) as f:
        train_config = yaml.safe_load(f)
    with open(args.decode_config) as f:
        decode_config = yaml.safe_load(f)
    tokenizer = BaseConfig(**train_config["tokenizer_config"]
                           ).generateExample()
    test_dataset = BaseConfig(**decode_config["test_data_config"]
                              ).generateExample(tokenizer=tokenizer)
    test_dataset.load_check_data()

    model = BaseConfig(**train_config["model_config"]).generateExample(
        device=device)
    load_model_weights(model, load_reference_checkpoint(
        args.model_path, args.choose, args.avg))
    frontend = DeviceFrontend([t for t in test_dataset.audio_trans
                               if not t.startswith("specaug")])
    decoder = DecodeMethod(model, tokenizer, decode_config["decode_config"],
                           device)

    acc = ErrorRateAccumulator()
    # per-batch timing; the first batch of each padded shape is left out
    # of the "steady" split, as in the JAX CLI (there it absorbs the
    # compile)
    shapes_seen = set()
    t_total = t_steady = audio_total = audio_steady = 0.0
    n_batches = 0
    items = list(test_dataset.train_set)
    with open(args.output_file, "w", encoding="utf-8") as out, \
            (open(args.output_file + ".nbest", "w", encoding="utf-8")
             if decoder.nbest > 1 else contextlib.nullcontext()) \
            as nbest_out, torch.no_grad():
        for lo in range(0, len(items), args.batch):
            chunk = items[lo: lo + args.batch]
            batch = test_dataset.merge_batch(chunk)
            t_batch = time.perf_counter()
            feats, feat_len = frontend(
                torch.from_numpy(batch["wav_array"]).to(device),
                torch.from_numpy(batch["wav_len"]).to(device))
            hyps = decoder(feats, feat_len, len(chunk))
            dt = time.perf_counter() - t_batch
            secs = float(np.sum(batch["wav_len"])) / 16000.0
            t_total += dt
            audio_total += secs
            n_batches += 1
            key = tuple(batch["wav_array"].shape)
            if key in shapes_seen:
                t_steady += dt
                audio_steady += secs
            else:
                shapes_seen.add(key)
            for b, item in enumerate(chunk):
                _, ref_id = tokenizer.encode(item["text"])
                _, ref = tokenizer.decode(ref_id, no_special=True)
                hyp = hyps[b].text   # a wfst graph emits the word text
                if hyp is None:
                    _, hyp = tokenizer.decode(hyps[b].ids, no_special=True)
                dist = acc.add(ref, hyp)
                print(f"id {item['id']}\nref: {ref}\nhyp: {hyp}\ndis: {dist}")
                out.write(f"{hyp} ({item['id']})\n")
                if nbest_out is not None:
                    for rank, (ids, sc) in enumerate(hyps[b].nbest):
                        _, text = tokenizer.decode(ids, no_special=True)
                        nbest_out.write(
                            f"{item['id']}-{rank + 1} {sc:.4f} {text}\n")
    print(f"Totol WER is {acc.rate}")
    print(acc.report())
    print(json.dumps({
        "decode_batches": n_batches,
        "decode_total_s": round(t_total, 2),
        "audio_total_s": round(audio_total, 2),
        "rtf": round(t_total / audio_total, 4) if audio_total else None,
        "decode_steady_s": round(t_steady, 2),
        "audio_steady_s": round(audio_steady, 2),
        "rtf_steady": round(t_steady / audio_steady, 4)
        if audio_steady else None}))
    return 0


if __name__ == "__main__":
    print(" ".join(sys.argv))
    sys.exit(main())
