"""Ranks of the data-parallel CPU tests (``test_torch_port_dp.py``), run
as ``python -m tests.torch_port_dp_worker <mode> ...`` in a process of
their own: no JAX is imported here or in the ranks it spawns.

  step DIR   ``spec["ranks"]`` ranks (default 2; ``parallel.dist.spawn``)
             read ``DIR/spec.pt`` (model widths, the frontend chain, rank
             0's initial weights, global batches, ``acc_grads``, Adam's
             settings, the device: ``cpu``, ``cuda:0`` for every rank, or
             ``cuda`` for rank r on ``cuda:r``; the backend, default
             ``gloo``; optionally ``model_parallel``, ``seq_parallel``,
             ``pipeline_parallel``, ``fsdp``, ``fsdp_min_size``,
             ``float64`` and ``model``: ``MODELS``' key, default the
             Conformer), build the model (ranks
             > 0 from other seeds: rank 0's weights arrive by
             broadcast), take the global
             gradient of the first batch (``Trainer.loss_and_grads``, the
             BatchNorm statistics put back after it), then one
             ``train_step`` per batch on their data rank's rows
             (``shard_rows``), and write ``DIR/rank<r>.pt``: the metrics,
             the gradient, the final state_dict and EMA shadow (whole,
             gathered from the shards), and each leaf's shard shape.
             With ``spec["layouts"]`` (a list of such specs over the same
             ranks) the one process group runs each in turn
             (``dist.set_grid``), writing ``DIR/rank<r>_<i>.pt``; a
             layout with ``encode`` = (features, lengths) instead
             encodes them in eval mode with the encoder's time split
             (``act_sharding``) and writes ``{"hs", "hs_len"}``.
  one DIR    the one-process runs of ``DIR/one.pt`` (a list of (spec,
             rows, init): ``one_process_run``'s arguments) in turn,
             writing ``DIR/one_<i>.pt``: the tests' references,
             computed beside the ranks and the main process's
             ``lasr_tpu`` steps (``start_one_process``).
  cli ARGV   ``lasr_tpu_torch.bin.train.main(ARGV)``; with
             ``DP_KILL_AFTER=N`` in the environment every rank raises
             "simulated preemption" when it asks for its (N+1)-th train
             batch (as ``tests/helpers.py``'s ``KillAfter``).

The tests' side of it lives here too (``Worker``, ``start_ranks``,
``ranks_result``, ``assert_step_equal``): the card's test file imports no
JAX either.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import torch

from lasr_tpu_torch.data.dataset import AudioDataSet
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.models.e2e_ctc_att import (E2E_Conformer_CTC,
                                                E2E_Transformer_CTC)
from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.modules.layers import set_compute_dtype
from lasr_tpu_torch.parallel import dist
from lasr_tpu_torch.train.optimizer import Adam
from lasr_tpu_torch.train.trainer import Trainer

# seconds each multi-process case may take, its ranks' start included;
# also the process group's timeout
TIMEOUT_S = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/torch_port_common.py's TINY Conformer at d=32, dropout 0
KW = dict(idim=20, odim=9, encoder_attention_dim=32,
          encoder_attention_heads=2, encoder_linear_units=32,
          encoder_num_blocks=2, decoder_attention_dim=32,
          decoder_attention_heads=2, decoder_linear_units=32,
          decoder_num_block=2, encoder_pos_enc_layer_type="rel_pos",
          encoder_selfattention_layer_type="rel_selfattn",
          encoder_cnn_kernel=7, encoder_dropout_rate=0.0,
          decoder_dropout_rate=0.0, ctc_dropout=0.0)
MODELS = {"conformer": E2E_Conformer_CTC,
          "transformer": E2E_Transformer_CTC,
          "online": E2E_Transformer_CTC_Online}
_FLOAT = torch.Tensor.float
# parameters whose true gradient is 0 (test_torch_port_trainer.py)
NOISE_LEAVES = ("conv_module.depthwise_conv.bias", "linear_k.bias")


def _kill_after(n):
    batches = AudioDataSet.batches
    served = [0]

    def wrapped(self, *args, **kw):
        for b in batches(self, *args, **kw):
            if kw.get("shuffle"):
                if served[0] == n:
                    raise RuntimeError("simulated preemption")
                served[0] += 1
            yield b
    AudioDataSet.batches = wrapped


# spawned ranks import this module again (as __mp_main__): patch there too
if os.environ.get("DP_KILL_AFTER"):
    _kill_after(int(os.environ["DP_KILL_AFTER"]))


def wav_batch(seed, n, B, S=8000):
    """A global batch of ``B`` rows of ``S`` samples, ``n`` of them real
    (the rest zero-length), ragged lengths."""
    rng = np.random.default_rng(seed)
    lens = np.zeros(B, np.int32)
    lens[:n] = rng.integers(S * 3 // 5, S + 1, n)
    lens[0] = S
    wav = (0.2 * rng.standard_normal((B, S))).astype(np.float32)
    wav *= np.arange(S)[None, :] < lens[:, None]
    tlen = np.zeros(B, np.int32)
    tlen[:n] = rng.integers(3, 7, n)
    tok = rng.integers(3, KW["odim"], (B, 6)).astype(np.int32)
    return {"wav_array": wav, "wav_len": lens, "token_id": tok,
            "token_len": tlen}


def float64_everywhere(on=True):
    """Make this process compute the port's float32 paths in float64
    (``Tensor.float`` widens to float64): a check of the algebra alone,
    as float32's rounding, amplified by the model's conditioning, moves
    gradients ~1e-4 when only the order of sums changes.  ``on=False``
    puts float32 back."""
    torch.Tensor.float = (lambda self: self.to(torch.float64)) if on \
        else _FLOAT


def build_trainer(spec, device, init=None):
    """The port model of ``spec`` on ``device`` with the weights ``init``
    (if given) and its Trainer (which, under a process group, broadcasts
    rank 0's weights); with ``spec["float64"]`` in float64 (after
    ``float64_everywhere``)."""
    model = MODELS[spec.get("model", "conformer")](**spec["kw"],
                                                   device=device)
    if spec.get("float64"):
        model.double()
        set_compute_dtype(model, torch.float64)
    if init is not None:
        model.load_state_dict(init)
    extra = {k: spec[k] for k in ("fsdp", "fsdp_min_size") if k in spec}
    trainer = Trainer(model, E2E_Loss(spec["kw"]["odim"], smoothing=0.1,
                                      rate=0.3),
                      Adam(**spec["adam"]), DeviceFrontend(spec["chain"]),
                      use_ema=True, acc_grads=spec["acc_grads"], seed=0,
                      log_interval=1, device=device, **extra)
    return model, trainer


def run_steps(trainer, model, batches, rows):
    """The global gradient of batches[0] at step 0 (the BatchNorm
    statistics put back after it), then one train_step per batch; each
    batch through ``rows``."""
    start = {k: v.clone() for k, v in model.state_dict().items()}
    metrics0, grads0 = trainer.loss_and_grads(rows(batches[0]), 0)
    model.load_state_dict(start)
    state = trainer.init_state()
    steps = []
    for b in batches:
        state, m = trainer.train_step(state, rows(b))
        steps.append(m)
    full = trainer.layout.full_list
    return {"metrics0": {k: float(v.detach())
                         for k, v in metrics0.items()},
            "grads0": [g.detach().cpu() for g in full(grads0)],
            "steps": steps,
            "state_dict": {k: v.detach().cpu()
                           for k, v in trainer.full_state_dict().items()},
            "ema": [s.detach().cpu() for s in full(state.ema["shadow"])],
            "names": trainer.names,
            "shard_shapes": {n: tuple(m.shape) for n, m in
                             zip(trainer.names, trainer.masters)}}


def _rows(rows):
    """A one-process run's view of a global batch: ("pad", n) pads it to
    a multiple of n rows (``dist.pad_rows``); ("take", [i, ...]) takes
    those rows in that order."""
    kind, arg = rows
    if kind == "pad":
        return lambda b: dist.pad_rows(b, arg)
    return lambda b: {k: v[arg] for k, v in b.items()}


def one_process_run(spec, rows=("pad", 1), init=None):
    """``run_steps`` of ``spec`` in one process, on the weights that
    ``torch.manual_seed(0)`` builds (``spec["init"]``, which the ranks
    start from) or on ``init``; in float64 where the spec says."""
    float64_everywhere(bool(spec.get("float64")))
    try:
        torch.manual_seed(0)
        model, trainer = build_trainer(dict(spec, fsdp=False), "cpu", init)
        if init is None and "init" in spec:
            for k, v in model.state_dict().items():
                assert torch.equal(v, spec["init"][k]), k
        return run_steps(trainer, model, spec["batches"], _rows(rows))
    finally:
        float64_everywhere(False)


class Worker:
    """``python -m MODULE ARGS`` in a session of its own, one thread per
    process unless ``env`` says otherwise; ``wait`` kills it with its
    ranks after TIMEOUT_S."""

    def __init__(self, args, tmp, env=None,
                 module="tests.torch_port_dp_worker", name="worker"):
        env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
               **(env or {})}
        self.log = open(os.path.join(tmp, f"{name}.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args],
            cwd=REPO, env=env, stdout=self.log, stderr=subprocess.STDOUT,
            start_new_session=True)

    def wait(self):
        """(exit code or None if it was killed, its output)."""
        try:
            rc = self.proc.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
            rc = None
        self.log.seek(0)
        out = self.log.read()
        self.log.close()
        return rc, out


def _l2(got, want):
    """Relative L2 distance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _same_ranks(a, b):
    assert a["jax_modules"] == b["jax_modules"] == []
    assert a["steps"] == b["steps"] and a["metrics0"] == b["metrics0"]
    for x, y in zip(a["grads0"] + a["ema"], b["grads0"] + b["ema"]):
        assert torch.equal(x, y)
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k


def start_ranks(tmp, spec):
    torch.save(spec, os.path.join(tmp, "spec.pt"))
    return Worker(["step", tmp], tmp)


def start_one_process(tmp, runs, threads=None):
    """``one_process_run(*run)`` of each of ``runs`` in a process of its
    own, with ``threads`` threads, by default this process's (so its
    float32 sums split as they would here); ``one_process_results`` waits
    for them.  Under pytest-xdist's other workers a process with a thread
    for each core waits on its own OpenMP threads: on an 8-core host the
    tensor-parallel file's runs (1.6 s alone) took 72 s with 8 threads
    beside 16 busy processes and 3.3 s with one, so that file asks for
    one."""
    torch.save(runs, os.path.join(tmp, "one.pt"))
    return Worker(["one", tmp], tmp, name="one", env={
        "OMP_NUM_THREADS": str(threads or torch.get_num_threads())})


def one_process_results(tmp, worker, n):
    rc, out = worker.wait()
    assert rc == 0, out[-6000:]
    return [torch.load(os.path.join(tmp, f"one_{i}.pt"), weights_only=False)
            for i in range(n)]


def ranks_result(tmp, worker, n=2):
    """Rank 0's results, once every one of the ``n`` ranks has equal
    ones."""
    rc, out = worker.wait()
    assert rc == 0, out[-6000:]
    return layout_result(tmp, n)


def layout_result(tmp, n=2, tag=""):
    """Rank 0's results of ``rank<r><tag>.pt``, once every one of the
    ``n`` ranks has equal ones (an ``encode`` layout's: equal ``hs``)."""
    ranks = [torch.load(os.path.join(tmp, f"rank{r}{tag}.pt"),
                        weights_only=False) for r in range(n)]
    for other in ranks[1:]:
        if "hs" in other:
            assert torch.equal(other["hs"], ranks[0]["hs"])
        else:
            _same_ranks(ranks[0], other)
    return ranks[0]


def assert_step_equal(got, want, tol=1e-5, loose=None, noise=NOISE_LEAVES):
    """Rank 0's results (``run_steps``) against the one-process ones:
    every metric (relative), the first batch's gradient (relative L2; the
    leaves whose true gradient is 0 ~0 on both sides), the final weights,
    BatchNorm statistics and EMA shadow (absolute), all within ``tol``
    but the gradient leaves named by a suffix in ``loose`` ({suffix:
    tolerance}).  ``noise``: the suffixes of the leaves whose true
    gradient is 0.  Every quantity out of its tolerance is reported."""
    loose = loose or {}
    bad = []
    for k, v in want["metrics0"].items():
        err = abs(got["metrics0"][k] - v)
        if err > tol * abs(v) + 1e-6:
            bad.append(f"{k}: {got['metrics0'][k]} against {v}")
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert set(g) == set(w)
        for k in w:
            if abs(g[k] - w[k]) > tol * abs(w[k]) + 1e-6:
                bad.append(f"{k} step {i}: {g[k]} against {w[k]}")
    # the leaves whose true gradient is 0 hold rounding noise on both
    # sides (test_torch_port_trainer.py): ~0 against the largest gradient
    top = max(float(w.abs().max()) for w in want["grads0"])
    for name, g, w in zip(want["names"], got["grads0"], want["grads0"]):
        if name.endswith(noise):
            err = max(float(g.abs().max()), float(w.abs().max())) / top
            if err > tol:
                bad.append(f"gradient of {name}: {err:.3e} of the largest "
                           f"gradient")
            continue
        leaf_tol = next((t for suffix, t in loose.items()
                         if name.endswith(suffix)), tol)
        err = _l2(g, w)
        if err > leaf_tol:
            bad.append(f"gradient of {name}: {err:.3e} (relative L2) > "
                       f"{leaf_tol:g}")
    for k, w in want["state_dict"].items():
        err = float((torch.as_tensor(got["state_dict"][k]).double()
                     - torch.as_tensor(w).double()).abs().max())
        if err > tol:
            bad.append(f"{k}: {err:.3e}")
    for name, g, w in zip(want["names"], got["ema"], want["ema"]):
        err = float((g.double() - w.double()).abs().max())
        if err > tol:
            bad.append(f"EMA of {name}: {err:.3e}")
    assert not bad, "\n".join(bad)


def _grid(spec):
    return dict(model_parallel=spec.get("model_parallel", 1),
                seq_parallel=spec.get("seq_parallel", 1),
                pipeline_parallel=spec.get("pipeline_parallel", 1))


def _encode(spec, device):
    """The eval-mode encoder output of ``spec["encode"]`` with the
    encoder's time split over the grid's seq ranks."""
    model = MODELS[spec.get("model", "conformer")](**spec["kw"],
                                                   device=device)
    model.load_state_dict(spec["init"])
    model.encoder.act_sharding = True
    x, xlen = (torch.as_tensor(a, device=device) for a in spec["encode"])
    with torch.no_grad():
        hs, hs_len = model.encode(x, xlen)
    return {"hs": hs.cpu(), "hs_len": hs_len.cpu()}


def _run_layout(spec, device, path):
    float64_everywhere(bool(spec.get("float64")))
    dist.set_grid(**_grid(spec))
    rank = dist.rank()
    torch.manual_seed(1000 + rank)
    if "encode" in spec:
        out = _encode(spec, device)
    else:
        model, trainer = build_trainer(spec, device,
                                       spec["init"] if rank == 0 else None)
        d, n = dist.data_rank(), dist.data_size()
        out = run_steps(trainer, model, spec["batches"],
                        lambda b: dist.shard_rows(b, d, n))
    out["jax_modules"] = [n for n in sys.modules
                          if n.split(".")[0] in ("jax", "lasr_tpu")]
    torch.save(out, path)


def _step_rank(rendezvous, root):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(os.path.join(root, "spec.pt"), weights_only=False)
    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rendezvous.rank)
    dist.init(device, spec.get("backend", "gloo"), rendezvous,
              timeout_s=TIMEOUT_S)
    try:
        rank = dist.rank()
        layouts = spec.get("layouts")
        if layouts is None:
            _run_layout(spec, device, os.path.join(root, f"rank{rank}.pt"))
        for i, layout in enumerate(layouts or ()):
            _run_layout(dict(layout, device=spec.get("device", "cpu")),
                        device, os.path.join(root, f"rank{rank}_{i}.pt"))
    finally:
        dist.shutdown()


def main(argv):
    mode = argv[0]
    if mode == "step":
        spec = torch.load(os.path.join(argv[1], "spec.pt"),
                          weights_only=False)
        dist.spawn(_step_rank, spec.get("ranks", 2), (argv[1],))
        return 0
    if mode == "one":
        runs = torch.load(os.path.join(argv[1], "one.pt"),
                          weights_only=False)
        for i, run in enumerate(runs):
            torch.save(one_process_run(*run),
                       os.path.join(argv[1], f"one_{i}.pt"))
        return 0
    if mode == "cli":
        from lasr_tpu_torch.bin import train
        return train.main(argv[1:])
    raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
