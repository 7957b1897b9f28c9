"""The port's serving entry point and its copied front end, on CPU.

``cli/predict.py`` ``main_code`` serves a 2-utterance synthetic codes
corpus written with the port's own record writer, from a seeded
checkpoint, with ``--device cpu`` (the fused-kernel wrappers take their
plain versions for CPU tensors).  The copied config, TFRecord codec and
record schemas agree with the JAX package's.  A name the JAX factories do
not know (model, encoder, decoder, attention mechanism) raises the JAX
package's ``ValueError`` with its message.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import logging
import os

import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu import config as jax_config
from self_attention_tacotron_tpu.data import records as jax_records
from self_attention_tacotron_torch import config
from self_attention_tacotron_torch.cli.predict import main_code
from self_attention_tacotron_torch.data import records
from self_attention_tacotron_torch.data.dataset import load_utterance
from self_attention_tacotron_torch.models import (Batch, encoders,
                                                  tacotron_model_factory)
from self_attention_tacotron_torch.utils import convert

from test_torch_ops import ROOT, tiny_codes_hp

RECIPE = os.path.join(ROOT, "examples", "codes", "self-attention-tacotron.json")
TINY = ("num_symbols=30,embedding_dim=16,num_mels=10,cbhg_out_units=16,"
        "conv_channels=8,max_filter_width=4,projection1_out_channels=8,"
        "projection2_out_channels=8,encoder_prenet_out_units=[16,8],"
        "self_attention_out_units=8,attention1_out_units=8,"
        "attention2_out_units=8,attention_out_units=12,"
        "decoder_prenet_out_units=[8,4],decoder_out_units=16,"
        "decoder_self_attention_out_units=16,max_iters=6,decoder_min_iters=1,"
        "attention_kernel=4")


def _write_corpus(hp, root, lengths=(5, 9), n_codes=(4, 6)):
    rng = np.random.default_rng(0)
    keys = []
    for i, (L, n) in enumerate(zip(lengths, n_codes)):
        key = f"u{i}"
        phone = rng.integers(1, hp.num_symbols, L).astype(np.int64)
        records.write_source_record(records.SourceRecord(
            id=i, key=key, source=phone, source_length=L, text=f"text {i}",
            phone=phone, phone_length=L, phone_txt="p"),
            os.path.join(root, f"{key}.{hp.source_file_extension}"),
            with_phone=True)
        codes = np.eye(hp.num_mels, dtype=np.float32)[
            rng.integers(0, hp.num_mels, n)]
        records.write_code_target_record(records.CodeTargetRecord(
            id=i, key=key, lang="", codes=codes, codes_length=n,
            codes_width=hp.num_mels),
            os.path.join(root, f"{key}.{hp.target_file_extension}"))
        keys.append(key)
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("\n".join(keys) + "\n")
    return keys


def test_main_code_serves_a_corpus_on_cpu(tmp_path, capsys):
    hp = config.default_hparams().parse_json_file(RECIPE).parse(TINY)
    data, ckpt, out = (str(tmp_path / d) for d in ("data", "ckpt", "out"))
    os.makedirs(data)
    keys = _write_corpus(hp, data)
    convert.save_checkpoint(
        convert.init_parameters(tacotron_model_factory(hp), seed=1), ckpt, 3)
    rc = main_code(["--source-data-root", data, "--target-data-root", data,
                    "--checkpoint-dir", ckpt, "--output-dir", out,
                    "--hparam-json-file", RECIPE, "--hparams", TINY,
                    "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    for key in keys:
        assert f"predicted {key}:" in printed
        rec = jax_records.parse_prediction_record(
            jax_records.read_first_example(
                os.path.join(out, f"{key}.tfrecord")))
        assert rec.codes.shape[1] == hp.num_mels
        assert 1 <= rec.codes.shape[0] <= hp.max_iters
        np.testing.assert_array_equal(rec.codes.sum(1), 1.0)
        dump = np.fromfile(os.path.join(
            out, f"{key}.{hp.predicted_mel_extension}"), "<f4")
        np.testing.assert_array_equal(dump, rec.codes.reshape(-1))
        assert rec.ground_truth_codes.shape[1] == hp.num_mels


PALLAS = " (Pallas attention mode)"


@pytest.mark.parametrize("hparams,enc,dec", [
    ("", "fused_encode kernel", "fused_decode kernel"),
    ("use_pallas_attention=true,decoder_fused_inference=false,"
     "encoder_fused_inference=false",
     "fused_self_attention kernel" + PALLAS,
     "incremental_attention_step kernel" + PALLAS),
    # location-sensitive sources run through the fused decode kernel too
    ("attention=location_sensitive,use_pallas_attention=true",
     "fused_encode kernel", "fused_decode kernel"),
    ("attention=location_sensitive", "fused_encode kernel",
     "fused_decode kernel"),
], ids=["fused", "pallas", "location-pallas", "location"])
def test_model_logs_the_path_its_gates_chose(monkeypatch, caplog, hparams,
                                             enc, dec):
    hp = config.default_hparams().parse_json_file(RECIPE).parse(TINY)
    hp.parse(hparams)
    model = convert.init_parameters(tacotron_model_factory(hp), 1).eval()
    monkeypatch.setattr(encoders, "_logged_paths", set())
    with caplog.at_level(logging.INFO, logger=encoders.__name__):
        model(Batch(source=torch.tensor([[3, 5, 7, 2, 9]]),
                    source_length=torch.tensor([5])))
    logged = [r.getMessage() for r in caplog.records
              if r.name == encoders.__name__]
    assert logged == [f"encoder self-attention: {enc}",
                      f"decoder self-attention: {dec}"]


def test_main_code_without_checkpoint_fails(tmp_path):
    hp = config.default_hparams().parse_json_file(RECIPE).parse(TINY)
    os.makedirs(tmp_path / "data")
    _write_corpus(hp, str(tmp_path / "data"))
    assert main_code(["--source-data-root", str(tmp_path / "data"),
                      "--target-data-root", str(tmp_path / "data"),
                      "--checkpoint-dir", str(tmp_path / "none"),
                      "--output-dir", str(tmp_path / "out"),
                      "--hparam-json-file", RECIPE, "--hparams", TINY,
                      "--device", "cpu"]) == 1


def test_config_layering_matches_jax_package():
    for path in (RECIPE, os.path.join(ROOT, "examples", "codes_siwis",
                                      "tacotron.json")):
        ours = config.default_hparams().parse_json_file(path).parse(TINY)
        theirs = jax_config.default_hparams().parse_json_file(path).parse(
            TINY)
        assert ours.values() == theirs.values()


def test_records_read_back_by_the_jax_reader(tmp_path):
    hp = tiny_codes_hp()
    _write_corpus(hp, str(tmp_path), lengths=(6,), n_codes=(3,))
    src = str(tmp_path / f"u0.{hp.source_file_extension}")
    tgt = str(tmp_path / f"u0.{hp.target_file_extension}")
    ours = records.parse_source_record(records.read_first_example(src))
    theirs = jax_records.parse_source_record(
        jax_records.read_first_example(src))
    np.testing.assert_array_equal(ours.phone, theirs.phone)
    u = load_utterance(src, tgt, hp)
    assert u.source_length == 6 and u.source.shape == (32,)
    np.testing.assert_array_equal(u.source[:6], theirs.phone)
    assert not u.source[6:].any()
    assert u.target.shape == (3, hp.num_mels) and u.target_length == 3


def test_model_rejects_kinds_not_ported():
    """The port refuses no kind the JAX package builds: the MGC/LF0 kind,
    inference dropout, accent types, the transition agent and model-wide
    bf16 (``compute_dtype=bfloat16``), each refused before it was ported,
    build and serve."""
    import pytest
    batch = Batch(source=torch.randint(1, 30, (1, 7)),
                  source_length=torch.tensor([7]),
                  accent_type=torch.full((1, 7), 0x3100 + 3))
    for kw in (dict(tacotron_model="DualSourceSelfAttentionMgcLf0TacotronModel",
                    decoder="DualSourceMgcLf0TransformerDecoder",
                    num_mgcs=6, num_lf0s=9),
               dict(apply_dropout_on_inference=True),
               dict(use_accent_type=True,
                    encoder="SelfAttentionCBHGEncoderWithAccentType",
                    encoder_prenet_out_units_if_accent=(8, 6),
                    accent_type_prenet_out_units=(4, 2),
                    accent_type_embedding_dim=4),
               dict(compute_dtype="float16"),
               dict(compute_dtype="bfloat16")):
        model = convert.init_parameters(
            tacotron_model_factory(tiny_codes_hp(**kw)), 0).eval()
        out = model(batch)
        assert torch.isfinite(out.outputs).all()
        assert out.outputs.dtype == (torch.bfloat16 if kw.get(
            "compute_dtype") == "bfloat16" else torch.float32)
    # accent types need an accent-type encoder, as the JAX encoders' calls
    # do
    with pytest.raises(ValueError):
        tacotron_model_factory(tiny_codes_hp(use_accent_type=True))
    # speakers are ported (the VCTK recipe); the two tables exclude each
    # other, as in the JAX package
    assert tacotron_model_factory(tiny_codes_hp(
        use_speaker_embedding=True)).has_speaker
    with pytest.raises(ValueError):
        tacotron_model_factory(tiny_codes_hp(
            use_speaker_embedding=True, use_external_speaker_embedding=True))
    agent = tacotron_model_factory(tiny_codes_hp(
        use_forward_attention_transition_agent=True))
    assert hasattr(agent.decoder.attention_mechanism_0,
                   "transition_factor_projection")
    assert torch.get_default_dtype() == torch.float32


@pytest.mark.parametrize("name", ["tacotron_model", "encoder", "decoder",
                                  "attention"])
def test_unknown_names_raise_the_jax_error(name):
    """The port raises where it builds the model, the JAX package where it
    first sets the model up (the attention mechanism: its factory): the
    same ``ValueError``, the same message."""
    import jax
    from self_attention_tacotron_tpu.models import DecoderMode
    from self_attention_tacotron_tpu.models import \
        tacotron_model_factory as jax_factory
    from self_attention_tacotron_tpu.models.attention import \
        AttentionOptions as JaxOptions
    from self_attention_tacotron_tpu.models.attention import \
        attention_mechanism_factory as jax_mechanism
    from self_attention_tacotron_torch.models.attention import (
        AttentionOptions, attention_mechanism_factory)
    from test_tacotron_model import make_batch
    hp = tiny_codes_hp(**{name: "Bogus"})
    with pytest.raises(ValueError) as port:
        tacotron_model_factory(hp)
    with pytest.raises(ValueError) as ref:
        if name == "attention":      # the model's init would run the encoder
            jax_mechanism(JaxOptions("Bogus", 4))
        else:
            jax_factory(hp).init(jax.random.PRNGKey(0), make_batch(hp),
                                 DecoderMode.INFERENCE)
    assert str(port.value) == str(ref.value)
    assert str(port.value).startswith("Unknown ")
    if name == "attention":
        with pytest.raises(ValueError) as direct:
            attention_mechanism_factory(AttentionOptions("Bogus", 4), 8, 8)
        assert str(direct.value) == "Unknown attention mechanism: Bogus"
