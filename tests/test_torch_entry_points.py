"""The port's plots, replay, small entry points, converter and profiler, on
CPU against the JAX package.

* ``utils.metrics``: ``plot_predictions`` and ``MetricsSaver`` write the
  JAX package's file names (``{mode}_step{step:09d}_{key}.png``), with its
  ``keep_max`` cleanup (needs matplotlib: skipped without it); without
  matplotlib nothing is written and the saver says so once.
* ``cli.predict.make_alignment_replay`` against the JAX package's on the
  same weights (the fused decode and the Pallas mode, the fused encoder
  beside them; early stop off): outputs, source and decoder self-attention
  alignments within 1e-5, equal lengths; None for the plain paths.
* ``make_train_step(hp, with_alignments=True)``: the same update and
  metrics as the plain step, and row 0 of the TRAIN forward's alignments
  and outputs.
* ``cli.postprocess`` and ``cli.debug_tfrecord`` against the JAX CLIs on
  one prediction record: the same files and the same dump.
* ``scripts/torch_from_jax_checkpoint.py``: a tiny orbax checkpoint of the
  JAX package into ``model-<n>.pt``; the two models' VALIDATION outputs
  within 1e-5.
* ``entry()`` on CPU; ``cli.train`` with ``alignment_save_steps``, an
  evaluation and ``record_profile``: the PNGs on the JAX package's cadence
  and names, the Chrome trace and its log line.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import importlib.util
import io
import json
import os
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.cli import debug_tfrecord as jax_debug
from self_attention_tacotron_tpu.cli import postprocess as jax_postprocess
from self_attention_tacotron_tpu.cli.predict import \
    make_alignment_replay as jax_replay
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.utils import metrics as jax_metrics
from self_attention_tacotron_torch.cli import debug_tfrecord, postprocess
from self_attention_tacotron_torch.cli.predict import make_alignment_replay
from self_attention_tacotron_torch.data import records
from self_attention_tacotron_torch.models import tacotron_model_factory
from self_attention_tacotron_torch.parallel import (create_train_state,
                                                    make_train_step)
from self_attention_tacotron_torch.utils import convert, metrics

from test_tacotron_model import make_batch
from test_torch_ops import ROOT, jit_create_state, np_tree, tiny_codes_hp
from test_torch_train_step import port_batch, write_codes_corpus

TOL = 1e-5


def _saver_run(module, out_dir, log=None):
    kw = {} if log is None else {"log": log}
    saver = module.MetricsSaver(out_dir, save_steps=2, mode="eval",
                                keep_max=2, **kw)
    rng = np.random.default_rng(0)
    paths = []
    for step in range(1, 6):
        paths.append(saver.save(step, f"k{step}", "a text",
                                [rng.random((5, 4))], rng.random((4, 3)),
                                rng.random((4, 3))))
    return paths, sorted(os.listdir(out_dir))


def test_saver_writes_the_jax_file_names(tmp_path):
    pytest.importorskip("matplotlib")
    got, got_files = _saver_run(metrics, str(tmp_path / "port"))
    ref, ref_files = _saver_run(jax_metrics, str(tmp_path / "jax"))
    assert got_files == ref_files == ["eval_step000000002_k2.png",
                                      "eval_step000000004_k4.png"]
    lists = []
    for module in (metrics, jax_metrics):    # the MGC/LF0 flavour
        out = tmp_path / (module.__name__.split(".")[0] + "_mgc")
        saver = module.MetricsSaver(str(out), save_steps=1, mode="train")
        saver.save_mgc_lf0(3, "k", "t", [np.eye(4)], np.zeros((5, 3)),
                           np.ones((6, 3)), np.zeros(5), np.ones(6))
        lists.append(sorted(os.listdir(out)))
    assert lists[0] == lists[1] == ["alignment_train_step000000003_k.png",
                                    "mgc_lf0_train_step000000003_k.png"]
    assert [p and os.path.basename(p) for p in got] == \
        [p and os.path.basename(p) for p in ref]
    assert metrics.plot_predictions(
        [np.eye(3)], None, np.ones((4, 2)), "t", "k",
        str(tmp_path / "k.png"), predicted_postnet=np.ones((4, 2)))
    assert os.path.getsize(tmp_path / "k.png") > 0


def test_without_matplotlib_no_png_is_written_and_said_once(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(metrics, "_pyplot", lambda: None)
    said = []
    log = type("Log", (), {"warning": lambda self, m: said.append(m)})()
    paths, files = _saver_run(metrics, str(tmp_path), log)
    assert paths == [None] * 5 and files == []
    assert said == [metrics.NO_PNG]
    assert not metrics.plot_alignment(np.eye(2), str(tmp_path / "a.png"))


def _replay_hp(**kw):
    return tiny_codes_hp(decoder_early_stop=False, **kw)


@functools.lru_cache(maxsize=None)
def _jax_state():
    """One JAX state for every case: the serving flags change no weight.
    Jitted (one compile, not one an operation of the init's forward): the
    eager state, bit for bit."""
    hp = _replay_hp()
    full = make_batch(hp, B=1, T_in=7, T_out=6)
    model = jax_factory(hp)
    return jit_create_state(model, hp, full, jax.random.PRNGKey(0)), full


@pytest.mark.parametrize("kw", [
    dict(decoder_fused_inference=True),
    dict(decoder_fused_inference=True, encoder_fused_inference=True),
    dict(use_pallas_attention=True)], ids=["fused", "fused-encoder",
                                           "pallas"])
def test_replay_matches_the_jax_replay(kw):
    hp = _replay_hp(**kw)
    state, full = _jax_state()
    jb = full._replace(target=None, done=None)
    ref = jax.tree_util.tree_map(np.asarray, jax_replay(hp, state)(jb))
    model = tacotron_model_factory(hp).eval()
    model.load_state_dict(convert.from_flax(np_tree(
        {"params": state.params, "batch_stats": state.batch_stats})))
    replay = make_alignment_replay(hp, model)
    got = replay(port_batch(full)._replace(target=None, done=None))
    np.testing.assert_allclose(got.outputs.numpy(), ref.outputs, rtol=0,
                               atol=TOL)
    pairs = [*zip(got.alignments, ref.alignments),
             *zip(got.decoder_self_attention_alignments,
                  ref.decoder_self_attention_alignments)]
    assert len(pairs) == 4
    for g, r in pairs:
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=TOL)
    assert all(r.any() for _, r in pairs)      # real probabilities
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)


def test_no_replay_for_the_plain_paths():
    hp = tiny_codes_hp(decoder_fused_inference=False,
                       use_pallas_attention=False)
    assert make_alignment_replay(hp, tacotron_model_factory(hp)) is None


def test_train_step_with_alignments():
    from test_torch_train_step import train_hp
    hp = train_hp()
    batch = port_batch(make_batch(hp, B=2, T_in=7, T_out=6))
    models = [convert.init_parameters(tacotron_model_factory(hp), seed=4)
              for _ in range(3)]
    # the TRAIN forward the step runs: its generator is the step's
    from self_attention_tacotron_torch.parallel.train_step import \
        step_generator
    models[2].train()
    fwd = models[2].train_forward(batch, step_generator(hp, 0, "cpu"))
    plain_state, plot_state = (create_train_state(m, hp) for m in models[:2])
    plain = make_train_step(hp)(plain_state, batch)
    metrics_, (aligns, outputs) = make_train_step(
        hp, with_alignments=True)(plot_state, batch)
    assert plot_state.step == plain_state.step == 1
    for k in plain:
        torch.testing.assert_close(metrics_[k], plain[k], rtol=0, atol=0)
    for a, p in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(a, p, rtol=0, atol=0)
    assert len(aligns) == len(fwd.alignments) == 2
    for a, r in zip(aligns, fwd.alignments):
        assert not a.requires_grad
        torch.testing.assert_close(a, r[0].detach(), rtol=0, atol=TOL)
    torch.testing.assert_close(outputs, fwd.outputs[0].detach(), rtol=0,
                               atol=TOL)


def _prediction_record(path):
    rng = np.random.default_rng(3)
    codes = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 7)]
    truth = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 5)]
    records.write_prediction_record(records.PredictionRecord(
        id=3, key="utt3", codes=codes, ground_truth_codes=truth,
        text="a text", source=np.array([4, 5, 6])), path)


def test_postprocess_and_dump_match_the_jax_clis(tmp_path):
    pred = tmp_path / "pred"
    pred.mkdir()
    _prediction_record(str(pred / "utt3.tfrecord"))
    outs = []
    for name, main in (("port", postprocess.main),
                       ("jax", jax_postprocess.main)):
        out = tmp_path / name
        assert main([str(pred), str(out), "--experiment", "e"]) == 0
        outs.append({f: (out / f).read_text() for f in sorted(
            os.listdir(out))})
    assert outs[0] == outs[1]
    assert set(outs[0]) == {"utt3.txt", "utt3.preds.txt", "utt3.truth.txt",
                            "tacotron_e.txt", "tacotron_e.hypothesis.txt",
                            "tacotron_e.true.txt"}
    dumps = []
    for main in (debug_tfrecord.main, jax_debug.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main([str(pred / "utt3.tfrecord")]) == 0
        dumps.append(buf.getvalue())
    assert dumps[0] == dumps[1] and "'utt3'" in dumps[0]


def test_converter_round_trips_an_orbax_checkpoint(tmp_path):
    from self_attention_tacotron_tpu.models import DecoderMode
    from self_attention_tacotron_tpu.utils.checkpoint import \
        CheckpointManager
    hp = tiny_codes_hp()
    state, full = _jax_state()
    jax_model = jax_factory(_replay_hp())
    mgr = CheckpointManager(str(tmp_path / "jax"))
    mgr.save(5, jax.device_get(state), force=True)
    mgr.wait()
    mgr.close()
    spec = importlib.util.spec_from_file_location(
        "torch_from_jax_checkpoint",
        os.path.join(ROOT, "scripts", "torch_from_jax_checkpoint.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    path = script.convert(str(tmp_path / "jax"), str(tmp_path / "port"), hp)
    assert os.path.basename(path) == "model-5.pt"
    model = tacotron_model_factory(hp).eval()
    assert convert.load_checkpoint(model, str(tmp_path / "port")) == 5
    ref = jax_model.apply({"params": state.params,
                           "batch_stats": state.batch_stats}, full,
                          DecoderMode.VALIDATION, True)
    with torch.no_grad():
        got = model.validation_forward(port_batch(full), True)
    np.testing.assert_allclose(got.outputs.numpy(), np.asarray(ref.outputs),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.stop_token.numpy(),
                               np.asarray(ref.stop_token), rtol=0, atol=TOL)


def test_entry_runs_on_cpu():
    from self_attention_tacotron_torch.entry import entry
    fn, (model, batch) = entry(device="cpu")
    loss = fn(model, batch)
    assert loss.shape == () and torch.isfinite(loss)
    assert float(fn(model.state_dict(), batch)) == float(loss)


def test_train_cli_plots_and_profiles_on_cpu(tmp_path, caplog):
    from self_attention_tacotron_torch.cli.train import main
    hp = tiny_codes_hp()
    data, ckpt = str(tmp_path / "data"), str(tmp_path / "ckpt")
    os.makedirs(data)
    keys = write_codes_corpus(hp, data, 4)
    with open(os.path.join(data, "validation.csv"), "w") as f:
        f.write("\n".join(keys[:2]) + "\n")
    hp_json = tmp_path / "hp.json"
    hp_json.write_text(json.dumps(hp.values()))
    assert main(["--source-data-root", data, "--target-data-root", data,
                 "--checkpoint-dir", ckpt, "--hparam-json-file",
                 str(hp_json), "--device", "cpu", "--max-steps", "2",
                 "--hparams",
                 "batch_size=2,max_iters=12,alignment_save_steps=2,"
                 "record_profile=true,"
                 "profile_steps=1,save_checkpoints_steps=2,"
                 "eval_start_delay_secs=0,eval_throttle_secs=0"]) == 0
    text = open(os.path.join(ckpt, os.path.basename(hp.logfile))).read()
    assert "profile of steps 1-1: device busy not measured" in text
    assert os.path.exists(os.path.join(ckpt, "profile",
                                       "trace_step2.json"))
    if importlib.util.find_spec("matplotlib") is None:
        assert text.count(metrics.NO_PNG) == 2      # once a saver
        return
    train_pngs = os.listdir(os.path.join(ckpt, "alignments"))
    assert len(train_pngs) == 1 and train_pngs[0].startswith(
        "train_step000000002_")
    assert [f.split("_")[1] for f in os.listdir(
        os.path.join(ckpt, "eval"))] == ["step000000002"]


@pytest.mark.parametrize("hparams,pyplot,replayed", [
    ("", True, True), ("use_forced_alignment_mode=true", True, False),
    ("decoder_fused_inference=false", True, False), ("", False, True)],
    ids=["fused", "forced", "plain", "no-pyplot"])
def test_predict_writes_a_png_an_utterance(tmp_path, capsys, caplog,
                                           monkeypatch, hparams, pyplot,
                                           replayed):
    """``main_code`` plots each utterance: through the replay on the fused
    decode (the recipe's path), from the forced-alignment mode's second
    pass, or from the plain decode itself.  Where matplotlib is found but
    its pyplot does not load, the replay still runs, and the run says once
    that it writes no PNG."""
    from self_attention_tacotron_torch import config
    from self_attention_tacotron_torch.cli.predict import main_code
    from test_torch_predict import RECIPE, TINY, _write_corpus
    hp = config.default_hparams().parse_json_file(RECIPE).parse(TINY)
    if not pyplot:
        monkeypatch.setattr(metrics, "have_matplotlib", lambda: True)
        monkeypatch.setattr(metrics, "_pyplot", lambda: None)
    data, ckpt, out = (str(tmp_path / d) for d in ("data", "ckpt", "out"))
    os.makedirs(data)
    keys = _write_corpus(hp, data)
    convert.save_checkpoint(
        convert.init_parameters(tacotron_model_factory(hp), seed=1), ckpt, 3)
    assert main_code(["--source-data-root", data, "--target-data-root", data,
                      "--checkpoint-dir", ckpt, "--output-dir", out,
                      "--hparam-json-file", RECIPE, "--device", "cpu",
                      "--hparams", ",".join(filter(None, (TINY, hparams)))]
                     ) == 0
    captured = capsys.readouterr()
    can_plot = metrics.have_matplotlib()
    assert captured.out.count("the alignment replay") == (
        len(keys) if replayed and can_plot else 0)
    if not pyplot or not can_plot:
        assert caplog.text.count(metrics.NO_PNG) == 1
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    if pyplot and can_plot:
        assert pngs == [f"{k}.png" for k in keys]
    else:
        assert pngs == []


@pytest.mark.parametrize("spans,busy", [
    ([], 0.0), ([(0, 10)], 10.0), ([(0, 10), (5, 20)], 20.0),
    ([(30, 40), (0, 10), (5, 8)], 20.0), ([(0, 10), (10, 12)], 12.0)])
def test_device_busy_is_the_union_of_intervals(spans, busy):
    from self_attention_tacotron_torch.cli.train import union_length
    assert union_length(spans) == busy


def test_device_spans_are_the_device_work_of_a_trace(tmp_path):
    """Kernels, copies and sets count; the step annotation the profiler
    mirrors on the device's rows and the host's ops do not."""
    from self_attention_tacotron_torch.cli.train import device_spans
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 20.5, "dur": 1},
        {"ph": "X", "cat": "gpu_memset", "ts": 30, "dur": 2},
        {"ph": "X", "cat": "gpu_user_annotation", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 50},
        {"ph": "i", "cat": "kernel", "ts": 40}]}))
    assert device_spans(str(path)) == [(10, 15), (20.5, 21.5), (30, 32)]
