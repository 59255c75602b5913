"""lasr_tpu's orbax checkpoints read by the port (``utils/zstd.py``,
``utils/ocdbt.py``, the orbax paths of ``utils/weights.py``,
``decode/lm.py`` and ``Trainer.restore_checkpoint``), on the CPU against
``zstandard``, orbax and ``lasr_tpu`` at tiny widths (a Conformer of 2 + 1
blocks, d = 16):

  (a) the zstd decoder equals ``zstandard`` at levels -5, 1, 3 and 19, with
      and without a checksum, on empty, one-byte, incompressible and
      multi-block (> 128 KiB) data, several frames and a skippable frame;
      corrupt and truncated frames raise ``ValueError``; a failed build
      of the decoder raises;
  (b) the reader equals ``ocp.StandardCheckpointer.restore`` bitwise, leaf
      for leaf: on the ``last`` and ``best`` steps that ``lasr_tpu``'s
      ``Trainer.save_checkpoint`` writes, on a tree sharded over the 8 CPU
      devices (several zstd chunks per array) with a ``bfloat16`` leaf and
      scalars, and on an ``encoder_scan_layers`` model's tree, whose
      unstacked blocks load into the port's model;
  (c) orbax reads the writer's output: ``lasr_tpu``'s
      ``load_averaged_params`` and ``load_lm_params`` give back the trees
      written; ``model_to_flax`` gives ``lasr_tpu``'s layout; and the
      checkpoint ``chip_smoke.py`` embeds is what orbax restores;
  (d) the port's average of 2 steps equals ``lasr_tpu``'s
      ``average_checkpoints`` bitwise (the same float64 sums in the same
      order), and its decode weights are the EMA shadow's;
  (e) ``ASRProcess`` and the decode CLI on the orbax root with an orbax
      RNNLM: the same ids and text as ``lasr_tpu``'s ``ASRProcess``, and
      the beam search's nbest 2 scores within 1e-3;
  (f) ``-resume_ckpt`` of ``lasr_tpu``'s step directory: the port's step
      from it has the loss of ``lasr_tpu``'s resumed step within 1e-4, and
      carries the Adam count and the EMA's ``num_updates``.

``lasr_tpu``'s Trainer starts from seeded weights drawn from the shapes of
its init (no compile), then takes 2 steps, saved as steps 1 and 2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import yaml

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu.data.frontend import DeviceFrontend as JaxFrontend
from lasr_tpu.decode.lm import load_lm_params
from lasr_tpu.models.losses import E2E_Loss as JaxLoss
from lasr_tpu.modules.rnn import RNNCellStack as JaxRNNCellStack
from lasr_tpu.parallel.mesh import make_mesh, replicated
from lasr_tpu.process.asrprocess import ASRProcess as JaxASRProcess
from lasr_tpu.train.ema import ema_init as jax_ema_init
from lasr_tpu.train.optimizer import Adam as JaxAdam
from lasr_tpu.train.trainer import TrainState as JaxTrainState
from lasr_tpu.train.trainer import Trainer as JaxTrainer
from lasr_tpu.train.trainer import average_checkpoints, load_averaged_params
from lasr_tpu_torch.bin import decode as port_decode
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.data.reader import write_wav
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.process.asrprocess import ASRProcess
from lasr_tpu_torch.train.optimizer import Adam
from lasr_tpu_torch.train.trainer import Trainer
from lasr_tpu_torch.utils import ocdbt, zstd
from lasr_tpu_torch.utils.weights import (average_orbax_checkpoints,
                                          flax_to_state_dict,
                                          load_model_weights,
                                          load_reference_checkpoint,
                                          model_to_flax)
from tests.torch_port_common import TINY, seeded_variables

zstandard = pytest.importorskip("zstandard")

KW = dict(TINY, encoder_num_blocks=2, decoder_num_block=1,
          encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
          ctc_dropout=0.0)
CHAIN = ["norm", "fbank:20"]
ADAM = dict(lr=1e-3, eps=1e-3)
LM_KW = dict(input_dim=TINY["odim"], output_dim=TINY["odim"], n_layers=1,
             n_units=16)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    n = np.asarray([8000, 5600, 6400], np.int32)
    wav = (0.2 * rng.standard_normal((3, 8000))).astype(np.float32)
    wav *= np.arange(8000)[None, :] < n[:, None]
    return {"wav_array": wav, "wav_len": n,
            "token_id": rng.integers(3, TINY["odim"], (3, 6)).astype(np.int32),
            "token_len": np.asarray([6, 4, 5], np.int32)}


def _numpy(leaf):
    """A leaf as numpy bits to compare: bfloat16 as its int16 view."""
    if torch.is_tensor(leaf):
        return leaf.view(torch.int16).numpy() \
            if leaf.dtype == torch.bfloat16 else leaf.numpy()
    leaf = np.asarray(leaf)
    return leaf.view(np.int16) if leaf.dtype == jnp.bfloat16 else leaf


def assert_trees_equal(got, want, path="tree"):
    """Same structure (dicts, sequences, None for optax's empty states),
    each leaf bitwise equal with its dtype and shape."""
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    else:
        g, w = _numpy(got), _numpy(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        np.testing.assert_array_equal(g, w, err_msg=path)


# ---- (a) zstd ----

def _payloads():
    rng = np.random.default_rng(0)
    return {
        "empty": b"", "one": b"a", "random": rng.bytes(4096),
        "floats": (np.round(rng.standard_normal(36000) * 8) / 8
                   ).astype(np.float32).tobytes(),      # 144 KB: 2 blocks
        "text": open(ocdbt.__file__, "rb").read()}


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_zstd_matches_zstandard(level, checksum):
    for name, data in _payloads().items():
        frame = zstandard.ZstdCompressor(
            level=level, write_checksum=checksum).compress(data)
        assert zstd.decompress(frame) == data, name
        # streamed: no content size in the header
        c = zstandard.ZstdCompressor(level=level).compressobj()
        assert zstd.decompress(c.compress(data) + c.flush()) == data, name


def test_zstd_frames_skippable_and_corrupt():
    p = _payloads()
    comp = zstandard.ZstdCompressor(level=3, write_checksum=True)
    skippable = b"\x5a\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"hello"
    two = comp.compress(p["text"]) + skippable + comp.compress(p["floats"])
    assert zstd.decompress(two) == p["text"] + p["floats"]
    frame = comp.compress(p["text"])
    for cut in (3, 5, 20, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError):
            zstd.decompress(frame[:cut])
    bad = bytearray(frame)
    bad[-1] ^= 0xFF                       # the checksum
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))
    rng = np.random.default_rng(1)
    errors = 0
    for _ in range(200):                  # corrupt bytes: raise or differ
        bad = bytearray(frame)
        bad[rng.integers(4, len(bad))] ^= 1 << int(rng.integers(8))
        try:
            errors += zstd.decompress(bytes(bad)) != p["text"]
        except ValueError:
            errors += 1
    assert errors >= 195
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"\x00" * 16)
    # into a buffer of the content's size (how the reader decodes a chunk)
    both = p["text"] + p["floats"]
    out = zstd.decompress_to(two, np.empty(len(both), np.uint8))
    assert out.tobytes() == both
    for size in (len(p["text"]) - 1, len(p["text"]) + 1):
        with pytest.raises(ValueError, match="size|expected"):
            zstd.decompress_to(frame, np.empty(size, np.uint8))
    # magic, a header naming dictionary 7, one raw block of b"x"
    with_dict = b"\x28\xb5\x2f\xfd\x01\x00\x07\x09\x00\x00x"
    assert zstd.decompress(with_dict.replace(b"\x01\x00\x07",
                                             b"\x00\x00")) == b"x"
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(with_dict)


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """``utils/native.py``'s build (the zstd decoder's: no fallback)
    raises with the compiler's output and leaves no library behind."""
    from lasr_tpu_torch.utils import native
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cc").write_text("not C++\n")
    monkeypatch.setattr(native, "PKG", tmp_path)
    with pytest.raises(RuntimeError, match="broken.cc with g"):
        native.build_shared("broken")
    assert not list((tmp_path / "_build").iterdir())


# ---- the lasr_tpu run ----

def _seeded_state(jt, batch, seed=0):
    """A ``TrainState`` of seeded weights drawn from the shapes of the
    init (kernels N(0, 1/fan_in), norm scales and variances in [0.5,
    1.5], the rest N(0, 0.01)), with its Adam state and EMA."""
    shapes = jt.init_state_abstract(batch)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['scale']", "['var']")):
            x = rng.uniform(0.5, 1.5, s.shape)
        elif name.endswith("['kernel']"):
            x = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name.endswith("['embedding']"):
            x = rng.standard_normal(s.shape)
        else:
            x = 0.1 * rng.standard_normal(s.shape)
        return jnp.asarray(x.astype(s.dtype))
    params = jax.tree_util.tree_map_with_path(leaf, shapes.params)
    stats = jax.tree_util.tree_map_with_path(leaf, shapes.batch_stats)
    return jax.device_put(
        JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=stats, opt_state=jt.tx.init(params),
                      ema=jax_ema_init(params)), replicated(jt.mesh))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``lasr_tpu``'s Trainer: 2 steps from seeded weights, saved as
    steps 1 and 2 into ``last`` and step 2 into ``best``; then one
    more step from step 2 restored (its loss), and an RNNLM saved with
    ``ocp.StandardCheckpointer``."""
    root = tmp_path_factory.mktemp("orbax_run")
    batch = _batch()
    jt = JaxTrainer(jax_models.E2E_Conformer_CTC(**KW),
                    JaxLoss(TINY["odim"], smoothing=0.1, rate=0.3),
                    JaxAdam(**ADAM).make(), JaxFrontend(CHAIN),
                    mesh=make_mesh(devices=jax.devices()[:1]), use_ema=True,
                    seed=0, log_interval=1, exp_dir=str(root / "exp"))
    state = _seeded_state(jt, batch)
    for step in (1, 2):        # step 1 into last, step 2 into both
        state, _ = jt.train_step(state, batch)
        jt.save_checkpoint(state, {"loss_main": 1.0} if step == 2 else None,
                           step=step, wait=True)
    step_dir = str(root / "exp" / "checkpoints" / "last" / "2")
    resumed = jt.restore_checkpoint(state, path=os.path.join(step_dir,
                                                             "default"))
    _, metrics = jt.train_step(resumed, batch)
    lm_shapes = jax.eval_shape(JaxRNNCellStack(**LM_KW).init,
                               jax.random.PRNGKey(0), None,
                               jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(7)
    lm_params = jax.tree.map(
        lambda s: (0.5 * rng.standard_normal(s.shape)).astype(s.dtype),
        lm_shapes["params"])
    lm_dir = str(root / "lm_orbax")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(lm_dir, {"params": lm_params})
    return dict(root=root, batch=batch, ckpts=str(root / "exp" /
                                                  "checkpoints"),
                step_dir=step_dir, loss=float(metrics["loss_main"]),
                state=jax.device_get(state), lm_dir=lm_dir,
                lm_params=lm_params)


# ---- (b) the reader against orbax ----

@pytest.mark.parametrize("manager,step", [("last", 1), ("best", 2)])
def test_reader_equals_orbax_on_the_trainers_checkpoints(run, manager, step):
    item = os.path.join(run["ckpts"], manager, str(step), "default")
    with ocp.StandardCheckpointer() as ckptr:
        want = ckptr.restore(item)
    got = ocdbt.load_tree(item)
    assert set(got) == {"step", "params", "opt_state", "batch_stats", "ema"}
    assert_trees_equal(got, want)
    assert int(got["step"]) == int(got["ema"]["num_updates"]) == step


def test_reader_equals_orbax_on_a_sharded_tree(tmp_path):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    rng = np.random.default_rng(3)
    w = np.round(rng.standard_normal((64, 48)) * 4).astype(np.float32)
    tree = {
        "w": jax.device_put(w, NamedSharding(mesh, P("a", "b"))),
        "h": jax.device_put(jnp.asarray(w[:8], jnp.bfloat16),
                            NamedSharding(mesh, P("a"))),
        "i": np.arange(10, dtype=np.int64), "u": np.arange(5, dtype=np.uint32),
        "f64": rng.standard_normal(7), "mask": rng.random(9) > 0.5,
        "scalar": np.float32(2.5), "n": np.int32(-4),
        "seq": [np.ones(3, np.float32), {"x": np.zeros(2, np.float32)}]}
    path = str(tmp_path / "sharded")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, tree)
    with ocp.StandardCheckpointer() as ckptr:
        want = ckptr.restore(path)
    store = ocdbt.OcdbtStore(path)
    assert sum(k.startswith("w/") and not k.endswith(".zarray")
               for k in store.keys()) == 8
    got = ocdbt.load_tree(path)
    assert got["h"].dtype == torch.bfloat16
    assert isinstance(got["seq"], list)
    assert_trees_equal(got, want)


def test_reader_unstacks_a_scan_layers_tree(tmp_path):
    kw = dict(KW, encoder_scan_layers=True)
    x = np.zeros((1, 40, TINY["idim"]), np.float32)
    args = (x, np.asarray([40], np.int32), np.ones((1, 4), np.int32))
    stacked = seeded_variables(jax_models.E2E_Conformer_CTC(**kw), 5, *args)
    assert "layers" in stacked["params"]["encoder"]
    path = str(tmp_path / "scan")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, {"params": stacked["params"],
                          "batch_stats": stacked["batch_stats"]})
    sd = load_reference_checkpoint(path)
    model = E2E_Conformer_CTC(**KW, device="cpu")
    load_model_weights(model, sd)
    block = jax.tree.map(lambda a: np.asarray(a)[1],
                         stacked["params"]["encoder"]["layers"]["block"])
    one = flax_to_state_dict({"params": {"encoder": {"layers_1": block}}})
    for k, v in one.items():
        assert torch.equal(sd[k], v), k
    # a pipelined encoder's [stages, blocks per stage, ...] leaves
    pipelined = str(tmp_path / "pipe")
    w = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    ocdbt.save_tree(pipelined, {"params": {"encoder": {"pipe_stages": {
        "block": {"norm_ff": {"bias": w}}}}}})
    sd = load_reference_checkpoint(pipelined)
    for i in range(4):
        assert torch.equal(sd[f"encoder.encoders.{i}.norm_ff.bias"],
                           torch.from_numpy(w[i // 2, i % 2])), i


def test_chip_smoke_blob_is_what_orbax_restores(tmp_path):
    """``chip_smoke.py``'s embedded checkpoint (orbax's own output, read
    on the card) unpacks to a tree that orbax restores leaf for leaf as
    the port reads it, with the digests the script holds it to."""
    import base64
    import io
    import tarfile
    import chip_smoke
    path = str(tmp_path / "blob")
    with tarfile.open(fileobj=io.BytesIO(
            base64.b64decode(chip_smoke.ORBAX_BLOB))) as tar:
        tar.extractall(path, filter="data")
    with ocp.StandardCheckpointer() as ckptr:
        want = ckptr.restore(path)
    got = ocdbt.load_tree(path)
    assert_trees_equal(got, want)
    assert chip_smoke.leaf_digests(got) == chip_smoke.ORBAX_BLOB_LEAVES


# ---- (c) the writer read by orbax and lasr_tpu ----

def test_orbax_reads_the_writer(run, tmp_path):
    state = run["state"]
    tree = {"step": state.step, "params": state.params,
            "opt_state": state.opt_state, "batch_stats": state.batch_stats,
            "ema": state.ema}
    port_tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    root = str(tmp_path / "checkpoints")
    for step in (3, 4):
        ocdbt.save_step(os.path.join(root, "last"), step, port_tree)
    with ocp.CheckpointManager(os.path.join(root, "last")) as mgr:
        assert mgr.all_steps() == [3, 4]
    params, stats = load_averaged_params(root, "last", avg=2)
    assert_trees_equal(params, state.ema["shadow"])
    assert_trees_equal(stats, state.batch_stats)
    item = os.path.join(root, "last", "4", "default")
    with ocp.StandardCheckpointer() as ckptr:
        back = ckptr.restore(item)
    assert_trees_equal(ocdbt.load_tree(item), back)
    # every chunk a zstd frame of raw / RLE blocks that zstandard decodes
    store = ocdbt.OcdbtStore(item)
    chunks = [bytes(store.read(k)) for k in store.keys()
              if not k.endswith(".zarray")]
    assert len(chunks) == len(jax.tree.leaves(tree))
    for chunk in chunks:
        assert zstandard.ZstdDecompressor().decompressobj().decompress(
            chunk) == zstd.decompress(chunk)
    np.testing.assert_array_equal(
        back["opt_state"][1][0]["mu"]["ctc"]["Dense_0"]["kernel"],
        state.opt_state[1][0].mu["ctc"]["Dense_0"]["kernel"])
    lm = str(tmp_path / "lm")
    ocdbt.save_tree(lm, {"params": run["lm_params"]})
    assert_trees_equal(load_lm_params(lm), run["lm_params"])


def test_model_to_flax_is_lasr_tpus_layout():
    """``model_to_flax`` (how a port model's state reaches ``save_tree``)
    equals ``lasr_tpu``'s ``torch_to_flax`` of its state_dict, and
    ``flax_to_state_dict`` takes it back."""
    from lasr_tpu.utils.torch_compat import torch_to_flax
    from lasr_tpu_torch.utils.weights import state_dict_to_numpy
    torch.manual_seed(0)
    model = E2E_Conformer_CTC(**KW, device="cpu")
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5)
    got = model_to_flax(model)
    assert_trees_equal(got, torch_to_flax(state_dict_to_numpy(
        model.state_dict())))
    back = flax_to_state_dict(got)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    names = [n for n, _ in model.named_parameters()]
    moments = {n: torch.full_like(p, 0.5) for n, p in
               model.named_parameters()}
    assert_trees_equal(model_to_flax(model, moments)["params"],
                       jax.tree.map(lambda a: np.full_like(a, 0.5),
                                    got["params"]))
    assert len(names) == len(jax.tree.leaves(got["params"]))


# ---- (d) averaging ----

@pytest.mark.parametrize("avg", [1, 2])
def test_average_equals_lasr_tpus(run, avg):
    last = os.path.join(run["ckpts"], "last")
    want = average_checkpoints(last, "last", avg)
    got, steps = average_orbax_checkpoints(last, avg)
    assert steps == [2, 1][:avg]
    assert_trees_equal(got, want)
    sd = load_reference_checkpoint(run["ckpts"], "last", avg)
    ema = flax_to_state_dict({"params": want["ema"]["shadow"],
                              "batch_stats": want["batch_stats"]})
    assert sd.keys() == ema.keys()
    for k in sd:
        assert torch.equal(sd[k], ema[k]), k


# ---- (e) decoding ----

def _decode_files(run, tmp_path, lm_path):
    (tmp_path / "dict.txt").write_text("\n".join("ABC"))
    with open(tmp_path / "hparams.yaml", "w") as f:
        yaml.safe_dump({
            "model_config": {
                "name": "lasr_tpu.models.e2e_ctc_att:E2E_Conformer_CTC",
                "kwargs": KW},
            "tokenizer_config": {
                "name": "lasr_tpu.data.tokenizer:CharTokenizer",
                "kwargs": {"dict_path": str(tmp_path / "dict.txt")}}}, f)
    wav = str(tmp_path / "u1.wav")
    write_wav(wav, run["batch"]["wav_array"][0], 16000)
    (tmp_path / "wav.scp").write_text(f"u1 {wav}\n")
    (tmp_path / "text").write_text("u1 AB\n")
    with open(tmp_path / "decode.yaml", "w") as f:
        yaml.safe_dump({
            "decode_config": {
                "decode_method": "ctc_att", "beam": 3, "ctc_beam": 4,
                "ctc_weight": 0.5, "nbest": 2, "lm_rate": 0.3,
                "lm_path": lm_path,
                "lm_config": {"name": "lasr_tpu.modules.rnn:RNNCellStack",
                              "kwargs": LM_KW}},
            "test_data_config": {
                "name": "lasr_tpu.data.dataset:AudioDataSet",
                "kwargs": {"wav_list": [str(tmp_path / "wav.scp")],
                           "text_list": [str(tmp_path / "text")],
                           "audio_trans": CHAIN}}}, f)
    return (str(tmp_path / "hparams.yaml"), str(tmp_path / "decode.yaml"),
            wav)


def test_asrprocess_and_cli_decode_the_orbax_root(run, tmp_path):
    hparams, dec, wav = _decode_files(run, tmp_path, run["lm_dir"])
    ours = ASRProcess(hparams, dec, run["ckpts"], "last", 2, device="cpu")
    ref = JaxASRProcess(hparams, dec, run["ckpts"], "last", 2)
    w, n = ref.frontend_wave(wav)
    feats, feat_len = ref.frontend(jnp.asarray(w[None]),
                                   jnp.asarray([n], jnp.int32))
    feats, feat_len = np.array(feats), np.array(feat_len)
    want = ref.decoder(feats, feat_len)
    got = ours.decoder.beam(feats, feat_len)
    assert [ids for ids, _ in got.nbest_ids(0)] == \
        [ids for ids, _ in want.nbest_ids(0)]
    np.testing.assert_allclose([s for _, s in got.nbest_ids(0)],
                               [s for _, s in want.nbest_ids(0)], atol=1e-3)
    text = ref.backend(want.best_ids(0))      # what ref(wav) returns
    assert ours(wav) == text
    out = str(tmp_path / "hyp.txt")
    assert port_decode.main(["-train_config", hparams, "-decode_config",
                             dec, "-model_path", run["ckpts"], "-choose",
                             "last", "-avg", "2", "-output_file", out,
                             "-device", "cpu"]) == 0
    with open(out) as f:
        assert f.read() == f"{text[1]} (u1)\n"


# ---- (f) resuming ----

def test_resume_from_a_lasr_tpu_step(run, tmp_path):
    model = E2E_Conformer_CTC(**KW, device="cpu")
    pt = Trainer(model, E2E_Loss(TINY["odim"], smoothing=0.1, rate=0.3),
                 Adam(**ADAM), DeviceFrontend(CHAIN), use_ema=True, seed=0,
                 log_interval=1, device="cpu")
    state = pt.restore_checkpoint(path=run["step_dir"])
    assert state.step == 2 and state.opt_state["count"] == 2
    assert state.ema["num_updates"] == 2
    want = flax_to_state_dict({"params": run["state"].params,
                               "batch_stats": run["state"].batch_stats})
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    mu = flax_to_state_dict({"params": run["state"].opt_state[1][0].mu})
    for name, m in zip(pt.names, state.opt_state["mu"]):
        assert torch.equal(m, mu[name]), name
    state, metrics = pt.train_step(state, run["batch"])
    assert state.opt_state["count"] == 3 and state.ema["num_updates"] == 3
    np.testing.assert_allclose(metrics["loss_main"], run["loss"], rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(FileNotFoundError, match="no orbax checkpoint"):
        pt.restore_checkpoint(path=str(tmp_path))
    # a run with -acc_grads 2: optax.MultiSteps holds the Adam state, the
    # accumulated gradient and mini_step
    import optax
    jstate = run["state"]
    multi = optax.MultiSteps(optax.adam(1e-3), every_k_schedule=2).init(
        jstate.params)
    multi = multi._replace(mini_step=jnp.asarray(1, jnp.int32),
                           acc_grads=jstate.opt_state[1][0].nu)
    path = str(tmp_path / "multi")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, {"step": jstate.step, "params": jstate.params,
                          "batch_stats": jstate.batch_stats,
                          "opt_state": multi, "ema": jstate.ema})
    state = pt.restore_checkpoint(path=path)
    assert state.mini_step == 1 and state.opt_state["count"] == 0
    nu = flax_to_state_dict({"params": jstate.opt_state[1][0].nu})
    for name, g in zip(pt.names, state.acc_grads):
        assert torch.equal(g, nu[name]), name
