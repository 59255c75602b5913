"""Decoding CLI (counterpart of the JAX package's ``bin/decode.py``).

    python -m lasr_tpu_torch.bin.decode -train_config exp/run/hparams.yaml \
        -decode_config conf/decode.yaml -model_path exp/run/checkpoints \
        -choose last -avg 10 -output_file exp/run/decode.txt

Loads the training ``hparams.yaml``, rebuilds tokenizer and model, averages
the ``-avg`` newest (``-choose last``) or best (``-choose best``)
checkpoints of a checkpoints root (EMA shadow preferred; a single
``.ckpt``/``.pt`` file or a directory of reference ``.ckpt`` files works
too), reads the test set with ``AudioDataSet`` and decodes it in batches
of ``-batch`` utterances with ``ctc_att`` (joint CTC/attention beam
search), ``ctc_att_online`` (its streaming form, for
``E2E_Transformer_CTC_Online``) or ``ctc_greedy``.  Prints ``id/ref/hyp/dis`` per utterance, the
total WER (as ``Totol WER is …``, the JAX CLI's spelling), the alignment
summary and an RTF line of JSON; writes ``<hyp> (<id>)`` lines to
``-output_file``.  Other decode methods, LM fusion, long-form decoding
and n-best output raise ``NotImplementedError`` (ROADMAP A8).  ``-device``
(default ``cuda``) picks the device.
"""

import argparse
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
    from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
    from lasr_tpu_torch.decode.greedy import ctc_greedy_decode
    from lasr_tpu_torch.utils.registry import BaseConfig
    from lasr_tpu_torch.utils.text import ErrorRateAccumulator
    from lasr_tpu_torch.utils.weights import (load_model_weights,
                                              load_reference_checkpoint)

    device = resolve_device(args.device)
    with open(args.train_config) as f:
        train_config = yaml.safe_load(f)
    with open(args.decode_config) as f:
        decode_config = yaml.safe_load(f)
    cfg = decode_config["decode_config"]
    method = cfg.get("decode_method", "ctc_att")
    if method not in ("ctc_att", "ctc_att_online", "ctc_greedy"):
        raise NotImplementedError(
            f"decode_method {method!r} is not ported (ROADMAP A8); ctc_att, "
            f"ctc_att_online and ctc_greedy are")
    if float(cfg.get("lm_rate") or 0.0) > 0.0 and cfg.get("lm_path"):
        raise NotImplementedError("LM shallow fusion is not ported "
                                  "(ROADMAP A8)")
    if int(cfg.get("longform_segment_frames", 0)) > 0:
        raise NotImplementedError("long-form decoding is not ported "
                                  "(ROADMAP A8)")
    if int(cfg.get("nbest", 1)) > 1:
        raise NotImplementedError("n-best output is not ported (ROADMAP A8)")

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
    decoder = None
    if method in ("ctc_att", "ctc_att_online"):
        decoder = CTCAttBeamDecoder(
            model, sos=tokenizer.ID_VALUE_SOS, eos=tokenizer.ID_VALUE_EOS,
            beam=cfg["beam"], ctc_beam=cfg["ctc_beam"],
            ctc_weight=cfg["ctc_weight"],
            online=method == "ctc_att_online", device=device)

    acc = ErrorRateAccumulator()
    # per-batch timing; the first batch of each padded shape is left out
    # of the "steady" split, as in the JAX CLI (there it absorbs the
    # compile)
    shapes_seen = set()
    t_total = t_steady = audio_total = audio_steady = 0.0
    n_batches = 0
    items = list(test_dataset.train_set)
    with open(args.output_file, "w", encoding="utf-8") as out, \
            torch.no_grad():
        for lo in range(0, len(items), args.batch):
            chunk = items[lo: lo + args.batch]
            batch = test_dataset.merge_batch(chunk)
            t_batch = time.perf_counter()
            feats, feat_len = frontend(
                torch.from_numpy(batch["wav_array"]).to(device),
                torch.from_numpy(batch["wav_len"]).to(device))
            if decoder is not None:
                hyps = decoder(feats, feat_len)
                hyp_ids = [hyps.best_ids(b) for b in range(len(chunk))]
            else:
                hs, hs_len = model.encode(feats, feat_len, solo_pad=True)
                hyp_ids = ctc_greedy_decode(model.ctc_logits(hs),
                                            hs_len)[: len(chunk)]
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
                _, hyp = tokenizer.decode(hyp_ids[b], no_special=True)
                dist = acc.add(ref, hyp)
                print(f"id {item['id']}\nref: {ref}\nhyp: {hyp}\ndis: {dist}")
                out.write(f"{hyp} ({item['id']})\n")
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
