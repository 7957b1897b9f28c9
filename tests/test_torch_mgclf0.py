"""The paper's pitch-accent configuration in the port, against the JAX
package on CPU: the MGC/LF0 model, accent types, their data and their
evaluation artifacts.

* The MGC/LF0 model (``DualSourceSelfAttentionMgcLf0TacotronModel``) under
  each of its three decoders, the last with accent types
  (``SelfAttentionCBHGEncoderWithAccentType``) and the hop-less one at r =
  2 with two fed frames: TRAIN loss and every gradient, VALIDATION
  teacher-forced and free-running, INFERENCE, at the tolerances of
  tests/test_torch_model_surface.py (``check_model_matches_jax``);
* ``make_eval_step``'s seven metrics (main key ``mgc_loss``);
* the port's ``Dataset`` against the JAX package's on the same mgclf0
  and accent records, array for array (``target``, ``target2``,
  ``accent_type``, masks), with unvoiced frames and f0 past both ends of
  [f0_min, f0_max];
* ``cli.train --dataset-kind mgclf0`` for 2 steps on CPU with one
  evaluation: its ``mgc_lf0`` metrics and its prediction record.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import json
import os

import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_torch.entry import PITCH_ACCENT

from test_tacotron_model import tiny_hp
from test_torch_model_surface import (ACCENT, DET, check_model_matches_jax,
                                      jax_reference, to_port)

MGCLF0 = dict(tacotron_model="DualSourceSelfAttentionMgcLf0TacotronModel",
              dataset="mgclf0.dataset.DatasetSource", num_mgcs=5,
              num_lf0s=7)
ACCENT_ENCODER = dict(ACCENT, encoder="SelfAttentionCBHGEncoderWithAccentType")
CASES = {
    "mgc_lf0_decoder_r2": dict(decoder="MgcLf0Decoder", outputs_per_step=2,
                               n_feed_frame=2),
    "mgc_lf0_dual_source_decoder": dict(decoder="MgcLf0DualSourceDecoder"),
    "dual_source_mgc_lf0_transformer_accent": dict(
        ACCENT_ENCODER, decoder="DualSourceMgcLf0TransformerDecoder"),
}


def mgc_hp(**kw):
    return tiny_hp(**dict(DET, **MGCLF0, **kw))


@functools.lru_cache(maxsize=None)
def reference(case):
    return jax_reference(mgc_hp(**CASES[case]))


@pytest.mark.parametrize("case", list(CASES))
def test_mgclf0_model_matches_jax(case):
    model, losses = check_model_matches_jax(mgc_hp(**CASES[case]),
                                            reference(case))
    assert model.is_mgclf0 and model.decoder.output_kind == "mgclf0"
    assert {"mgc_loss", "lf0_loss"} <= set(losses)
    assert ("accent_embedding.weight" in model.state_dict()) == (
        "accent" in case)


def test_eval_step_metrics_match_jax():
    from self_attention_tacotron_tpu.parallel.train_step import \
        TrainState as JaxState
    from self_attention_tacotron_tpu.parallel.train_step import \
        make_eval_step as jax_make_eval_step
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_eval_step)
    from self_attention_tacotron_torch.utils import convert
    case = "dual_source_mgc_lf0_transformer_accent"
    hp = mgc_hp(**CASES[case])
    v, jb, _, _ = reference(case)
    jstate = JaxState(step=0, params=v["params"],
                      batch_stats=v["batch_stats"], constants={},
                      opt_state=None)
    ref, _, _ = jax_make_eval_step(jax_factory(hp), hp)(jstate, jb)
    model = tacotron_model_factory(hp)
    model.load_state_dict(convert.from_flax(v), strict=True)
    got, _, _ = make_eval_step(hp)(create_train_state(model.eval(), hp),
                                   to_port(jb))
    assert set(got) == set(ref) == {
        "mgc_loss", "done_loss", "loss", "loss_with_teacher",
        "mgc_loss_with_teacher", "done_loss_with_teacher",
        "l2_regularization_loss"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_pitch_accent_overrides_build_at_the_defaults():
    """The shared constant of the tests and the chip smoke: the paper's
    configuration at the defaults' widths."""
    from self_attention_tacotron_torch.config import default_hparams
    from self_attention_tacotron_torch.models import tacotron_model_factory
    hp = default_hparams()
    for k, v in PITCH_ACCENT.items():
        hp.set_hparam(k, v)
    model = tacotron_model_factory(hp)
    dec = model.decoder
    assert (hp.num_mgcs, hp.num_lf0s, hp.f0_min, hp.f0_max) == (
        60, 256, 66.0, 529.0)
    assert tuple(model.accent_embedding.weight.shape) == (129, 32)
    assert dec.mgc_prenets.prenet_0.dense.in_features == 60
    assert dec.lf0_prenets.prenet_0.dense.in_features == 256
    assert dec.lf0_out_projection.out_features == 256
    assert dec.num_sources == 2 and len(dec.transformers) == 1


def write_pitch_accent_corpus(root, hp, lengths, seed=7):
    """Source records with accent ids (one of them without, one with too
    few) and MGC/LF0 target records whose f0 tracks hold unvoiced frames
    and values past both ends of [f0_min, f0_max]; returns the keys."""
    from self_attention_tacotron_torch.data.records import (
        MgcLf0TargetRecord, SourceRecord, write_mgc_lf0_target_record,
        write_source_record)
    rng = np.random.default_rng(seed)
    keys = []
    for i, n in enumerate(lengths):
        key = f"utt{i}"
        src = rng.integers(1, hp.num_symbols, 5 + i).astype(np.int64)
        accent = (None if i == 1 else hp.accent_type_offset + rng.integers(
            0, hp.num_accent_type, len(src) - (2 if i == 2 else 0)))
        write_source_record(SourceRecord(
            id=i, key=key, source=src, source_length=len(src),
            text=f"utt {i}", accent_type=accent),
            os.path.join(root, f"{key}.source.tfrecord"), with_speaker=False)
        f0 = rng.uniform(30.0, 700.0, n).astype(np.float32)
        f0[rng.random(n) < 0.3] = 0.0
        f0[:3] = (-1.0, hp.f0_min, hp.f0_max)
        write_mgc_lf0_target_record(MgcLf0TargetRecord(
            i, key, rng.standard_normal((n, hp.num_mgcs)).astype(np.float32),
            hp.num_mgcs, f0, n), os.path.join(root, f"{key}.target.tfrecord"))
        keys.append(key)
    return keys


def test_mgclf0_batches_match_jax(tmp_path):
    from self_attention_tacotron_tpu.data import dataset as jds
    from self_attention_tacotron_torch.data import dataset as tds
    hp = mgc_hp(**ACCENT_ENCODER, approx_min_target_length=0,
                batch_bucket_width=64, max_iters=40)
    keys = write_pitch_accent_corpus(str(tmp_path), hp, [11, 13, 20, 7, 30])
    files = (tds.find_dataset_files(str(tmp_path), keys, "source.tfrecord"),
             tds.find_dataset_files(str(tmp_path), keys, "target.tfrecord"))
    assert tds.target_kind_of(hp) == "mgclf0"
    got = list(tds.dataset_factory(*files, hp, batch_size=2, shuffle=False))
    ref = list(jds.dataset_factory(*files, hp, batch_size=2, shuffle=False))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        for name in ("source", "source_length", "target", "target2",
                     "accent_type", "target_length", "done",
                     "spec_loss_mask", "binary_loss_mask"):
            a, b = getattr(g, name), getattr(r, name)
            assert a.shape == b.shape, name
            assert a.astype(b.dtype).tobytes() == b.tobytes(), name
    classes = np.concatenate([g.target2[i, :n].argmax(-1) for g in got
                              for i, n in enumerate(g.target_length)])
    assert {0, 1, hp.num_lf0s - 1} <= set(classes.tolist())
    accents = np.concatenate([g.accent_type.ravel() for g in got])
    assert hp.accent_type_unknown in accents
    # the model batch carries both
    mb = tds.to_model_batch(got[0])
    assert mb.accent_type.shape == mb.source.shape
    assert mb.target[1].shape[-1] == hp.num_lf0s
    padded, n = tds.pad_model_batch_rows(mb, 4)
    assert n == 2 and padded.target[1].shape[0] == 4


def test_train_mgclf0_on_cpu_writes_its_evaluation(tmp_path):
    from self_attention_tacotron_torch.cli.train import main as train_main
    from self_attention_tacotron_torch.data.records import read_first_example
    data, ckpt = str(tmp_path / "data"), str(tmp_path / "ckpt")
    os.makedirs(data)
    hp = mgc_hp(**ACCENT_ENCODER, decoder="DualSourceMgcLf0TransformerDecoder")
    keys = write_pitch_accent_corpus(data, hp, [5, 6, 6, 5, 6])
    for name, part in (("train", keys[:4]), ("validation", keys[4:])):
        with open(os.path.join(data, f"{name}.csv"), "w") as f:
            f.write("\n".join(part) + "\n")
    hp_json = tmp_path / "hp.json"
    hp_json.write_text(json.dumps(dict(
        hp.values(), batch_size=2, save_checkpoints_steps=2,
        eval_start_delay_secs=0, eval_throttle_secs=0, max_iters=8,
        approx_min_target_length=0, batch_bucket_width=64)))
    assert train_main(["--source-data-root", data, "--target-data-root",
                       data, "--checkpoint-dir", ckpt, "--hparam-json-file",
                       str(hp_json), "--dataset-kind", "mgclf0", "--device",
                       "cpu", "--max-steps", "2"]) == 0
    metrics = [json.loads(x) for x in open(os.path.join(ckpt,
                                                        "metrics.jsonl"))]
    evals = [m for m in metrics if "eval/mgc_loss_with_teacher" in m]
    assert evals and all(np.isfinite(v) for v in evals[0].values())
    assert any("lf0_loss" in m for m in metrics)
    records = [f for f in os.listdir(os.path.join(ckpt, "eval"))
               if f.endswith(".tfrecord")]
    assert records == ["eval_step000000002_utt4.tfrecord"]
    ex = read_first_example(os.path.join(ckpt, "eval", records[0]))
    lf0 = np.frombuffer(ex["lf0"][1][0], np.float32).reshape(-1, 7)
    np.testing.assert_allclose(lf0.sum(-1), 1.0, rtol=1e-5)   # softmax
    assert torch.get_default_dtype() == torch.float32
