"""The port's mel model (``ExtendedTacotronV1Model``) against the JAX package.

The LJSpeech recipe's structure (``examples/ljspeech/tacotron.json``:
``ZoneoutEncoderV1`` with ``use_zoneout_at_encoder``, ``ExtendedDecoder``
with one forward-attention source, decoder v2, no self-attention hops,
r = 2) at tests/test_tacotron_model.py's tiny widths, with and without
``PostNetV2``; the JAX parameters (with random batch-norm statistics) are
carried across by ``utils/convert.py``.  Compared, float32 on CPU:

* INFERENCE (early stop): outputs, postnet outputs, stop logits and
  alignments within ``TOL_OUT``, equal lengths; no code output;
* VALIDATION free-running and teacher-forced.  Free-running, the mel model
  feeds back its raw frames; with the softmax feedback the port used for
  every model before (``feedback_softmax=True``) the outputs miss the JAX
  package's by far more than the tolerance (the repaired fault);
* TRAIN, deterministic (dropout and zoneout off): the loss, the outputs,
  every gradient (rtol 2e-3, atol 2e-5, as tests/test_torch_train_step.py)
  and the batch statistics, against JAX TRAIN with ``teacher_forcing``.
  The JAX package's own ``make_train_step`` calls TRAIN without it, and its
  hop-less decoders then feed back their outputs; that fault of the
  reference is not copied, and ``test_jax_train_step_free_runs_hopless``
  shows it;
* ``make_eval_step``'s seven metrics (main key ``mel_loss``);
* the batches of ``dataset_factory`` for mel targets (normalised frames,
  r silence frames at head and tail, the silence fill past each length),
  byte for byte;
* end to end on CPU: the port's ``cli.preprocess`` -> ``cli.train`` for 4
  steps (one evaluation) -> ``cli.predict.main_mel``; the ``.mfbsp`` dump
  equals the record's mel and the model's postnet output, not its raw one.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import DecoderMode
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.models.tacotron import Batch as JaxBatch
from self_attention_tacotron_tpu.models.tacotron import \
    compute_loss as jax_loss
from self_attention_tacotron_torch.models import (compute_loss,
                                                  tacotron_model_factory)
from self_attention_tacotron_torch.utils import convert

from test_mel_e2e import MEL_HPARAMS, ljspeech_corpus  # noqa: F401
from test_tacotron_model import tiny_hp
from test_torch_ops import np_tree
from test_torch_train_step import port_batch

TOL_OUT = 2e-4
TOL_ALIGN = 1e-5
MEL = dict(tacotron_model="ExtendedTacotronV1Model",
           encoder="ZoneoutEncoderV1", decoder="ExtendedDecoder",
           dataset="ljspeech.dataset.DatasetSource", attention="forward",
           attention_kernel=4, decoder_version="v2",
           use_zoneout_at_encoder=True, outputs_per_step=2, num_mels=8,
           max_iters=8, decoder_min_iters=1, use_l2_regularization=True)
POSTNET = dict(use_postnet_v2=True, num_postnet_v2_layers=2,
               postnet_v2_kernel_size=3, postnet_v2_out_channels=8)
DETERMINISTIC = dict(encoder_prenet_drop_rate=0.0,
                     decoder_prenet_drop_rate=0.0, postnet_v2_drop_rate=0.0,
                     zoneout_factor_cell=0.0, zoneout_factor_output=0.0)


def mel_hp(postnet: bool, **kw):
    return tiny_hp(**dict(MEL, **(POSTNET if postnet else {}), **kw))


def jax_batch(B=2, T_in=7, T_out=8, seed=0):
    rng = np.random.default_rng(seed)
    steps = T_out // 2
    return JaxBatch(
        source=rng.integers(1, 30, (B, T_in)).astype(np.int32),
        source_length=np.array([T_in, T_in - 2][:B], np.int32),
        target=rng.standard_normal((B, T_out, 8)).astype(np.float32),
        target_length=np.full((B,), T_out, np.int32),
        done=np.tile(np.eye(steps, dtype=np.float32)[-1], (B, 1)),
        spec_loss_mask=np.ones((B, T_out), np.float32),
        binary_loss_mask=np.ones((B, steps), np.float32),
        speaker_id=np.zeros((B,), np.int32),
        accent_type=np.zeros((B, T_in), np.int32))


@functools.lru_cache(maxsize=None)
def jax_variables(postnet):
    model = jax_factory(mel_hp(postnet))
    v = np_tree(jax.jit(lambda key, b: model.init(
        {"params": key}, b, DecoderMode.VALIDATION, True))(
            jax.random.PRNGKey(0), jax_batch()))
    rng = np.random.default_rng(3)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        v["batch_stats"])
    return v


@functools.lru_cache(maxsize=None)
def jax_decodes(postnet):
    """(INFERENCE, VALIDATION free-running, VALIDATION teacher-forced)."""
    model = jax_factory(mel_hp(postnet))

    @jax.jit
    def run(v, b):
        return (model.apply(v, b._replace(done=None), DecoderMode.INFERENCE),
                model.apply(v, b, DecoderMode.VALIDATION, False),
                model.apply(v, b, DecoderMode.VALIDATION, True))
    return jax.tree_util.tree_map(np.asarray,
                                  run(jax_variables(postnet), jax_batch()))


def port_model(postnet, **kw):
    model = tacotron_model_factory(mel_hp(postnet, **kw))
    model.load_state_dict(convert.from_flax(jax_variables(postnet)),
                          strict=True)
    return model.eval()


def _close(got, ref, tol, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=tol, err_msg=name)


def _check_outputs(got, ref, postnet):
    _close(got.outputs, ref.outputs, TOL_OUT, "outputs")
    _close(got.stop_token, ref.stop_token, TOL_OUT, "stop_token")
    assert len(got.alignments) == len(ref.alignments) == 1
    _close(got.alignments[0], ref.alignments[0], TOL_ALIGN, "alignments")
    assert got.code_output is None and ref.code_output is None
    assert got.encoder_self_attention_alignments == []
    assert got.decoder_self_attention_alignments == []
    if postnet:
        _close(got.postnet_outputs, ref.postnet_outputs, TOL_OUT, "postnet")
    else:
        assert got.postnet_outputs is None and ref.postnet_outputs is None
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)


@pytest.mark.parametrize("postnet", [False, True], ids=["raw", "postnet"])
def test_bridge_carries_the_mel_tree(postnet):
    state = convert.from_flax(jax_variables(postnet))
    model = tacotron_model_factory(mel_hp(postnet))
    assert set(state) == set(model.state_dict())
    assert any(k.startswith("encoder.prenets.") for k in state)
    assert any(k.startswith("encoder.cbhg.bilstm.") for k in state)
    assert any(k.startswith("postnet.conv_1.bn.") for k in state) == postnet
    back = convert.to_flax(state, model)
    for coll in ("params", "batch_stats"):
        a = jax.tree_util.tree_leaves_with_path(back[coll])
        b = dict(jax.tree_util.tree_leaves_with_path(
            jax_variables(postnet)[coll]))
        assert len(a) == len(b)
        for path, x in a:
            np.testing.assert_array_equal(x, b[path])


@pytest.mark.parametrize("postnet", [False, True], ids=["raw", "postnet"])
def test_inference_matches_jax(postnet):
    ref = jax_decodes(postnet)[0]
    got = port_model(postnet)(port_batch(jax_batch()))
    _check_outputs(got, ref, postnet)
    assert got.outputs.shape == (2, 2 * 8, 8)


@pytest.mark.parametrize("teacher_forcing", [False, True],
                         ids=["free", "teacher"])
@pytest.mark.parametrize("postnet", [False, True], ids=["raw", "postnet"])
def test_validation_matches_jax(postnet, teacher_forcing):
    ref = jax_decodes(postnet)[1 + int(teacher_forcing)]
    model = port_model(postnet)
    batch = port_batch(jax_batch())
    got = model.validation_forward(batch, teacher_forcing)
    _check_outputs(got, ref, postnet)
    assert not model.decoder.feedback_softmax
    if not teacher_forcing:   # the fault before the repair: softmax feedback
        model.decoder.feedback_softmax = True
        wrong = model.validation_forward(batch, False)
        err = float(np.abs(wrong.outputs.numpy() - ref.outputs).max())
        assert err > 10 * TOL_OUT, err


def test_codes_model_keeps_softmax_feedback():
    from test_torch_ops import tiny_codes_hp
    model = tacotron_model_factory(tiny_codes_hp())
    assert model.is_code_model and model.decoder.feedback_softmax


@functools.lru_cache(maxsize=None)
def jax_train(postnet):
    """JAX TRAIN, deterministic: teacher-forced (loss, outputs, new batch
    statistics, gradients) and the outputs of the default call."""
    hp = mel_hp(postnet, **DETERMINISTIC)
    model = jax_factory(hp)
    v, batch = jax_variables(postnet), jax_batch()
    rngs = {"dropout": jax.random.PRNGKey(1),
            "zoneout": jax.random.PRNGKey(2)}

    def loss(params, teacher_forcing):
        out, mut = model.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, batch,
                               DecoderMode.TRAIN, teacher_forcing, rngs=rngs,
                               mutable=["batch_stats"])
        return jax_loss(hp, out, batch, params)["loss"], (out, mut)

    (l, (out, mut)), g = jax.jit(jax.value_and_grad(
        lambda p: loss(p, True), has_aux=True))(v["params"])
    default_out = jax.jit(lambda p: loss(p, False)[1][0].outputs)(v["params"])
    return (float(l), np.asarray(out.outputs),
            None if out.postnet_outputs is None
            else np.asarray(out.postnet_outputs),
            np_tree(mut["batch_stats"]), np_tree(g), np.asarray(default_out))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("postnet", [False, True], ids=["raw", "postnet"])
def test_train_loss_and_every_gradient_match_jax(postnet):
    l_ref, out_ref, post_ref, stats_ref, g_ref, _ = jax_train(postnet)
    model = port_model(postnet, **DETERMINISTIC).train()
    batch = port_batch(jax_batch())
    out = model.train_forward(batch)
    losses = compute_loss(model.hp, out, batch, model)
    assert ("postnet_loss" in losses) == postnet and "code_loss" not in losses
    losses["loss"].backward()
    np.testing.assert_allclose(float(losses["loss"].detach()), l_ref,
                               rtol=1e-5)
    _close(out.outputs, out_ref, TOL_OUT, "outputs")
    if postnet:
        _close(out.postnet_outputs, post_ref, TOL_OUT, "postnet")
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    got, ref = _flat(convert.to_flax(grads, model)["params"]), _flat(g_ref)
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=2e-3,
                                   atol=2e-5, err_msg=name)
    stats = _flat(convert.to_flax(model.state_dict(), model)["batch_stats"])
    for name, x in _flat(stats_ref).items():
        np.testing.assert_allclose(stats[name], x, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_jax_train_step_free_runs_hopless():
    """JAX TRAIN without ``teacher_forcing`` (its make_train_step's call)
    feeds the hop-less decoder its own outputs: it differs from the
    teacher-forced pass that the port's TRAIN matches."""
    _, out_ref, _, _, _, default_out = jax_train(False)
    assert float(np.abs(default_out - out_ref).max()) > 100 * TOL_OUT
    np.testing.assert_allclose(default_out[:, :2], out_ref[:, :2], rtol=0,
                               atol=1e-6)   # step 0: both fed the GO frame


def test_eval_step_metrics_match_jax():
    from self_attention_tacotron_tpu.parallel.train_step import \
        TrainState as JaxState
    from self_attention_tacotron_tpu.parallel.train_step import \
        make_eval_step as jax_make_eval_step
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_eval_step)
    hp, v = mel_hp(True), jax_variables(True)
    jstate = JaxState(step=0, params=v["params"],
                      batch_stats=v["batch_stats"], constants={},
                      opt_state=None)
    jb = jax_batch(B=1)
    ref, _, _ = jax_make_eval_step(jax_factory(hp), hp)(jstate, jb)
    state = create_train_state(port_model(True), hp)
    got, _, _ = make_eval_step(hp)(state, port_batch(jb))
    assert set(got) == set(ref) == {
        "mel_loss", "done_loss", "loss", "loss_with_teacher",
        "mel_loss_with_teacher", "done_loss_with_teacher",
        "l2_regularization_loss"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def _write_mel_corpus(root, lengths, num_mels=8):
    from self_attention_tacotron_torch.data.records import (
        MelTargetRecord, SourceRecord, write_mel_target_record,
        write_source_record)
    rng = np.random.default_rng(7)
    keys = []
    for i, n in enumerate(lengths):
        key = f"utt{i}"
        src = rng.integers(1, 30, 5 + i).astype(np.int64)
        write_source_record(SourceRecord(
            id=i, key=key, source=src, source_length=len(src),
            text=f"utt {i}"), os.path.join(root, f"{key}.source.tfrecord"),
            with_speaker=False)
        mel = (rng.standard_normal((n, num_mels)) * 10 - 40).astype(
            np.float32)
        write_mel_target_record(MelTargetRecord(i, key, mel, num_mels, n),
                                os.path.join(root, f"{key}.target.tfrecord"))
        keys.append(key)
    return keys


def test_mel_batches_match_jax(tmp_path):
    from self_attention_tacotron_tpu.data import dataset as jds
    from self_attention_tacotron_torch.data import dataset as tds
    keys = _write_mel_corpus(str(tmp_path), [11, 13, 20, 7, 30])
    hp = mel_hp(False, approx_min_target_length=0, batch_bucket_width=64,
                max_iters=20,
                average_mel_level_db=list(np.linspace(-50, -30, 8)),
                stddev_mel_level_db=list(np.linspace(5, 12, 8)),
                silence_mel_level_db=-3.0, source="character")
    files = (tds.find_dataset_files(str(tmp_path), keys, "source.tfrecord"),
             tds.find_dataset_files(str(tmp_path), keys, "target.tfrecord"))
    assert tds.target_kind_of(hp) == "mel"
    got = list(tds.dataset_factory(*files, hp, batch_size=2, shuffle=False))
    ref = list(jds.dataset_factory(*files, hp, batch_size=2, shuffle=False))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        for name in ("source", "source_length", "target", "target_length",
                     "done", "spec_loss_mask", "binary_loss_mask"):
            a, b = getattr(g, name), getattr(r, name)
            assert a.shape == b.shape, name
            assert a.astype(b.dtype).tobytes() == b.tobytes(), name
    # r silence frames at the head, the fill past the shorter row's length
    assert np.all(got[0].target[:, :2] == -3.0)
    short = int(got[0].target_length.min())
    assert short % 2 == 0 and np.all(got[0].target[
        int(got[0].target_length.argmin()), short:] == -3.0)
    # MGC/LF0 targets are ported (tests/test_torch_mgclf0.py)
    assert tds.dataset_factory(*files, hp.replace(
        dataset="mgclf0.dataset")).target_kind == "mgclf0"


def test_preprocess_train_and_main_mel_on_cpu(ljspeech_corpus, tmp_path):  # noqa: F811
    from self_attention_tacotron_torch.cli.predict import main_mel
    from self_attention_tacotron_torch.cli.preprocess import main_ljspeech
    from self_attention_tacotron_torch.cli.train import main as train_main
    from self_attention_tacotron_torch.config import load_hparams
    from self_attention_tacotron_torch.data.dataset import (
        find_dataset_files, iter_utterances)
    from self_attention_tacotron_torch.data.records import (
        parse_mel_prediction_record, read_first_example)
    from self_attention_tacotron_torch.models import Batch
    root, keys = ljspeech_corpus
    data, ckpt, pred = (str(tmp_path / d) for d in ("data", "ckpt", "pred"))
    hp0 = tmp_path / "hp0.json"
    hp0.write_text(json.dumps(MEL_HPARAMS))
    assert main_ljspeech([str(root), data, "--hparam-json-file", str(hp0),
                          "--on-device", "--device", "cpu"]) == 0
    hp = dict(MEL_HPARAMS, attention="forward", attention_kernel=4,
              decoder_version="v2", use_zoneout_at_encoder=True, **POSTNET,
              postnet_v2_drop_rate=0.0)
    hp.update(json.load(open(os.path.join(data, "hparams.json"))))
    hp_json = tmp_path / "hp.json"
    hp_json.write_text(json.dumps(hp))
    for name, part in (("train", keys[:4]), ("validation", keys[4:5]),
                       ("test", keys[5:])):
        with open(os.path.join(data, f"{name}.csv"), "w") as f:
            f.write("\n".join(part) + "\n")
    common = ["--source-data-root", data, "--target-data-root", data,
              "--checkpoint-dir", ckpt, "--hparam-json-file", str(hp_json),
              "--device", "cpu"]
    assert train_main([*common, "--max-steps", "4"]) == 0
    metrics = [json.loads(x) for x in open(os.path.join(ckpt,
                                                        "metrics.jsonl"))]
    assert any("eval/mel_loss_with_teacher" in m for m in metrics)
    assert any("postnet_loss" in m for m in metrics)
    assert main_mel([*common, "--output-dir", pred]) == 0

    key = keys[5]
    dump = np.fromfile(os.path.join(pred, f"{key}.mfbsp"), "<f4").reshape(
        -1, 8)
    rec = parse_mel_prediction_record(read_first_example(
        os.path.join(pred, f"{key}.tfrecord")))
    np.testing.assert_array_equal(rec.mel, dump)
    hpo = load_hparams(type("A", (), {"hparam_json_file": str(hp_json),
                                      "hparams": ""})())
    model = tacotron_model_factory(hpo).eval()
    assert convert.load_checkpoint(model, ckpt) == 4
    u = next(iter_utterances(
        find_dataset_files(data, [key], hpo.source_file_extension),
        find_dataset_files(data, [key], hpo.target_file_extension), hpo,
        "mel"))
    np.testing.assert_array_equal(rec.ground_truth_mel,
                                  u.target[:u.target_length])
    out = model(Batch(torch.from_numpy(u.source[None]),
                      torch.tensor([u.source_length])))
    n = int(out.lengths[0]) * 2
    assert dump.shape == (n, 8) and np.all(np.isfinite(dump))
    np.testing.assert_allclose(dump, out.postnet_outputs[0, :n].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not np.allclose(dump, out.outputs[0, :n].numpy(), atol=1e-3)
