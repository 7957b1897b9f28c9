"""The port's speaker conditioning (the VCTK recipe) against the JAX package.

Module by module: ``MultiSpeakerPreNet``, ``ExternalEmbedding`` (a table
written as .npy, .npz and text) and ``PostNetV2``'s speaker projection.
Then the structure of ``examples/vctk/self-attention-tacotron.json``
(``DualSourceSelfAttentionTacotronModel``, the self-attention CBHG
encoder, ``DualSourceTransformerDecoder``, forward attention, decoder v2,
r = 2, mel targets, ``use_speaker_embedding`` at offset 225) at
tests/test_tacotron_model.py's tiny widths, three rows of different
source lengths and speakers, the JAX parameters carried across by
``utils/convert.py``.  Compared, float32 on CPU:

* INFERENCE on the plain loop and on the fused decode's plain version
  (the speaker row, batched rows; its source alignments are zeros for
  B > 1, as in the JAX package) within 2e-4;
* VALIDATION free-running and teacher-forced;
* TRAIN, deterministic, on the plain trunk and on the fused trunk's plain
  version: loss (rtol 1e-5), outputs (2e-4) and every gradient, the
  speaker embedding's included (rtol 2e-3, atol 2e-5, as
  tests/test_torch_train_step.py);
* the other routes: ``speaker_embedd_to_decoder`` (tiled onto both
  sources), ``speaker_embedd_to_postnet``, the projection and
  ``speaker_for_synthesis``;
* the recipe's code-model rule (queue 3 of ROADMAP.md): the model is keyed
  on its name, so a mel-target VCTK model trains ``0.1 * L1`` as
  ``code_loss`` and feeds back softmax probabilities free-running, in both
  packages;
* ``speaker_id`` through the data pipelines, and ``cli/speaker_selection``
  against the JAX package's on the same files.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
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
from self_attention_tacotron_torch.models import (Batch, compute_loss,
                                                  tacotron_model_factory)
from self_attention_tacotron_torch.utils import convert

from test_tacotron_model import tiny_hp
from test_torch_ops import close, load, np_tree, randn

TOL_OUT = 2e-4
VCTK = dict(dataset="vctk.dataset.DatasetSource", attention="forward",
            attention_kernel=4, cumulative_weights=False,
            decoder_version="v2", outputs_per_step=2, num_mels=8,
            max_iters=8, decoder_min_iters=1, use_zoneout_at_encoder=True,
            use_speaker_embedding=True, num_speakers=4,
            speaker_embedding_offset=225, speaker_embedding_dim=6,
            decoder_early_stop=False)
ROUTES = dict(speaker_embedd_to_decoder=True, speaker_embedd_to_postnet=True,
              speaker_embedding_projection_out_dim=5, use_postnet_v2=True,
              num_postnet_v2_layers=2, postnet_v2_kernel_size=3,
              postnet_v2_out_channels=8)
DETERMINISTIC = dict(encoder_prenet_drop_rate=0.0,
                     decoder_prenet_drop_rate=0.0, postnet_v2_drop_rate=0.0,
                     zoneout_factor_cell=0.0, zoneout_factor_output=0.0,
                     self_attention_drop_rate=0.0,
                     decoder_self_attention_drop_rate=0.0)
SPEAKERS = (225, 228, 226)


# ------------------------------------------------------------- modules

def test_multi_speaker_prenet_matches_jax():
    from self_attention_tacotron_tpu.models import prenet as jp
    from self_attention_tacotron_torch.models import prenet as tp
    x, spk = randn(0, 3, 10), randn(1, 3, 6)
    mod = jp.PreNetStack((8, 4), 0.5, use_speaker_embed=True)
    v = mod.init(jax.random.PRNGKey(0), x, spk)
    v = jax.tree_util.tree_map(lambda a: a + 0.05, v)   # non-zero biases
    ref = mod.apply(v, x, spk)
    port = load(tp.PreNetStack(10, (8, 4), 0.5, speaker_dim=6), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), False, None, torch.from_numpy(spk))
    close(got, ref)
    denses, drops = port.dense_layers()
    assert [d.out_features for d in denses] == [8, 8, 4]
    assert drops == (False, True, True)


@pytest.mark.parametrize("ext", [".npy", ".npz", ".txt"])
def test_external_embedding_matches_jax(tmp_path, ext):
    from self_attention_tacotron_tpu.models.embedding import \
        ExternalEmbedding as JaxExternal
    from self_attention_tacotron_torch.models.embedding import \
        ExternalEmbedding
    table = randn(2, 5, 3)
    path = str(tmp_path / f"speakers{ext}")
    {".npy": lambda: np.save(path, table),
     ".npz": lambda: np.savez(path, table=table),
     ".txt": lambda: np.savetxt(path, table)}[ext]()
    ids = np.array([[223, 225, 227], [229, 231, 226]], np.int32)  # clipped
    mod = JaxExternal(path, 5, 3, index_offset=225)
    ref = mod.apply(mod.init(jax.random.PRNGKey(0), ids), ids)
    port = ExternalEmbedding(path, 5, 3, index_offset=225)
    close(port(torch.from_numpy(ids)), ref)
    assert not list(port.parameters()) and not port.state_dict()
    with pytest.raises(ValueError):
        ExternalEmbedding(path, 4, 3)


def test_postnet_speaker_projection_matches_jax():
    from self_attention_tacotron_tpu.models.postnet import \
        MultiSpeakerPostNet as JaxPostNet
    from self_attention_tacotron_torch.models.postnet import PostNetV2
    xs, spk = randn(3, 2, 9, 8), randn(4, 2, 6)
    mod = JaxPostNet(8, num_layers=3, kernel_size=3, out_channels=12)
    v = np_tree(mod.init(jax.random.PRNGKey(1), xs, spk))
    rng = np.random.default_rng(5)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    ref = mod.apply(v, xs, spk)
    port = load(PostNetV2(8, 3, 3, 12, speaker_dim=6), v)
    assert port.conv_0.conv.weight.shape[1] == 8 + 12
    with torch.no_grad():
        got = port(torch.from_numpy(xs), False, None, torch.from_numpy(spk))
    close(got, ref)


# ------------------------------------------------- the VCTK structure

def vctk_hp(routes=False, **kw):
    return tiny_hp(**dict(VCTK, **(ROUTES if routes else {}), **kw))


def jax_batch(B=3, T_in=7, T_out=8, seed=0):
    rng = np.random.default_rng(seed)
    steps = T_out // 2
    return JaxBatch(
        source=rng.integers(1, 30, (B, T_in)).astype(np.int32),
        source_length=np.array([T_in, T_in - 2, T_in - 4][:B], np.int32),
        target=rng.standard_normal((B, T_out, 8)).astype(np.float32),
        target_length=np.full((B,), T_out, np.int32),
        done=np.tile(np.eye(steps, dtype=np.float32)[-1], (B, 1)),
        spec_loss_mask=np.ones((B, T_out), np.float32),
        binary_loss_mask=np.ones((B, steps), np.float32),
        speaker_id=np.array(SPEAKERS[:B], np.int32),
        accent_type=np.zeros((B, T_in), np.int32))


def port_batch(jb) -> Batch:
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Batch(source=t(jb.source), source_length=t(jb.source_length),
                 target=t(jb.target), target_length=t(jb.target_length),
                 done=t(jb.done), spec_loss_mask=t(jb.spec_loss_mask),
                 binary_loss_mask=t(jb.binary_loss_mask),
                 speaker_id=t(jb.speaker_id))


@functools.lru_cache(maxsize=None)
def jax_variables(routes=False):
    model = jax_factory(vctk_hp(routes))
    v = np_tree(jax.jit(lambda key, b: model.init(
        {"params": key}, b, DecoderMode.VALIDATION, True))(
            jax.random.PRNGKey(0), jax_batch()))
    rng = np.random.default_rng(3)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        v["batch_stats"])
    return v


@functools.lru_cache(maxsize=None)
def jax_decodes():
    """(INFERENCE, VALIDATION free-running, VALIDATION teacher-forced)."""
    model = jax_factory(vctk_hp())

    @jax.jit
    def run(v, b):
        return (model.apply(v, b._replace(done=None), DecoderMode.INFERENCE),
                model.apply(v, b, DecoderMode.VALIDATION, False),
                model.apply(v, b, DecoderMode.VALIDATION, True))
    return jax.tree_util.tree_map(np.asarray, run(jax_variables(),
                                                  jax_batch()))


def port_model(routes=False, **kw):
    model = tacotron_model_factory(vctk_hp(routes, **kw))
    model.load_state_dict(convert.from_flax(jax_variables(routes)),
                          strict=True)
    return model.eval()


def _close(got, ref, tol, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=tol, err_msg=name)


def _check(got, ref, aligns=True, postnet=False):
    _close(got.outputs, ref.outputs, TOL_OUT, "outputs")
    _close(got.stop_token, ref.stop_token, TOL_OUT, "stop_token")
    if aligns:
        for a, b in zip(got.alignments, ref.alignments):
            _close(a, b, TOL_OUT, "alignments")
    if postnet:
        _close(got.postnet_outputs, ref.postnet_outputs, TOL_OUT, "postnet")
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)


def test_bridge_carries_the_speaker_parameters():
    state = convert.from_flax(jax_variables())
    model = tacotron_model_factory(vctk_hp())
    assert set(state) == set(model.state_dict())
    assert state["speaker_embedding.weight"].shape == (4, 6)
    for name in ("dense0", "speaker_projection", "dense"):
        assert f"decoder.prenets.prenet_0.{name}.weight" in state
    paths = dict(convert.flax_param_paths(model))
    assert "decoder/prenets/prenet_0/speaker_projection/kernel" in paths
    assert "speaker_embedding/embedding" in paths


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_ref"])
def test_inference_matches_jax(fused):
    ref = jax_decodes()[0]
    model = port_model(decoder_fused_inference=fused)
    got = model(port_batch(jax_batch()))
    _check(got, ref, aligns=not fused)
    if fused:   # the batched fused decode returns no source alignments
        assert all(bool((a == 0).all()) for a in got.alignments)
    # each row's own speaker: another speaker id changes that row only
    other = port_batch(jax_batch())._replace(
        speaker_id=torch.tensor([227, 228, 226]))
    moved = model(other).outputs - got.outputs
    assert float(moved[0].abs().max()) > 1e-4
    assert float(moved[1:].abs().max()) == 0.0


@pytest.mark.parametrize("teacher_forcing", [False, True],
                         ids=["free", "teacher"])
def test_validation_matches_jax(teacher_forcing):
    ref = jax_decodes()[1 + int(teacher_forcing)]
    got = port_model().validation_forward(port_batch(jax_batch()),
                                          teacher_forcing)
    _check(got, ref)


@functools.lru_cache(maxsize=None)
def jax_train():
    hp = vctk_hp(**DETERMINISTIC)
    model = jax_factory(hp)
    v, batch = jax_variables(), jax_batch()

    def loss(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": v["batch_stats"]}, batch,
                             DecoderMode.TRAIN, True,
                             rngs={"dropout": jax.random.PRNGKey(1),
                                   "zoneout": jax.random.PRNGKey(2)},
                             mutable=["batch_stats"])
        return jax_loss(hp, out, batch, params)["loss"], out

    (l, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    return float(l), np.asarray(out.outputs), np_tree(g)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("fused", [False, True],
                         ids=["plain_trunk", "fused_trunk_ref"])
def test_train_loss_and_every_gradient_match_jax(fused):
    l_ref, out_ref, g_ref = jax_train()
    model = port_model(decoder_fused_train=fused, **DETERMINISTIC).train()
    batch = port_batch(jax_batch())
    out = model.train_forward(batch)
    losses = compute_loss(model.hp, out, batch, model)
    losses["loss"].backward()
    np.testing.assert_allclose(float(losses["loss"].detach()), l_ref,
                               rtol=1e-5)
    _close(out.outputs, out_ref, TOL_OUT, "outputs")
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    got, ref = _flat(convert.to_flax(grads, model)["params"]), _flat(g_ref)
    assert got.keys() == ref.keys()
    assert any("speaker_embedding" in k for k in ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=2e-3,
                                   atol=2e-5, err_msg=name)
    assert float(np.abs(got["['speaker_embedding']['embedding']"]).max()) \
        > 0


def test_vctk_recipe_keeps_the_code_model_rule():
    """Keyed on the model's name, as in the JAX package: the mel-target
    VCTK recipe trains 0.1 * L1 as code_loss and feeds back softmax
    probabilities in its free-running VALIDATION."""
    hp = vctk_hp()
    model = port_model()
    assert model.is_code_model and model.decoder.feedback_softmax
    batch = port_batch(jax_batch())
    out = model.validation_forward(batch, True)
    losses = compute_loss(hp, out, batch)
    ref = jax_loss(hp, jax.tree_util.tree_map(np.asarray,
                                              jax_decodes()[2]), jax_batch())
    assert "code_loss" in losses and "mel_loss" not in losses
    assert set(ref) >= {"code_loss", "done_loss", "loss"}
    np.testing.assert_allclose(float(losses["code_loss"]),
                               float(ref["code_loss"]), rtol=1e-5)
    l1 = (out.outputs - batch.target).abs().mean()
    np.testing.assert_allclose(float(losses["code_loss"]), 0.1 * float(l1),
                               rtol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_routes(synthesis):
    hp = vctk_hp(True, speaker_for_synthesis=synthesis)
    model = jax_factory(hp)
    b = jax_batch()._replace(done=None)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v: model.apply(v, b, DecoderMode.INFERENCE))(
            jax_variables(True)))


@pytest.mark.parametrize("synthesis", [-1, 227], ids=["own", "synthesis"])
def test_decoder_postnet_routes_and_synthesis_speaker_match_jax(synthesis):
    ref = jax_routes(synthesis)
    model = port_model(True, speaker_for_synthesis=synthesis)
    assert model.decoder.attention_mechanism_0.memory_layer.in_features \
        == 16 + 5      # the projected speaker tiled onto the source
    got = model(port_batch(jax_batch()))
    _check(got, ref, postnet=True)
    if synthesis > -1:   # one speaker for every row, whatever its id
        alt = port_batch(jax_batch())._replace(
            speaker_id=torch.tensor([226, 226, 226]))
        assert torch.equal(model(alt).outputs, got.outputs)


# ------------------------------------------------ data and speaker lists

def _write_speaker_corpus(root, speakers, num_mels=8):
    from self_attention_tacotron_torch.data.records import (
        MelTargetRecord, SourceRecord, write_mel_target_record,
        write_source_record)
    rng = np.random.default_rng(11)
    keys = []
    for i, spk in enumerate(speakers):
        key = f"p{spk}_{i:03d}"
        src = rng.integers(1, 30, 5 + i).astype(np.int64)
        write_source_record(SourceRecord(
            id=i, key=key, source=src, source_length=len(src),
            text=f"utt {i}", speaker_id=spk),
            os.path.join(root, f"{key}.source.tfrecord"))
        n = 9 + 2 * i
        mel = (rng.standard_normal((n, num_mels)) * 10 - 40).astype(
            np.float32)
        write_mel_target_record(MelTargetRecord(i, key, mel, num_mels, n),
                                os.path.join(root, f"{key}.target.tfrecord"))
        keys.append(key)
    return keys


def test_speaker_ids_in_batches_match_jax(tmp_path):
    from self_attention_tacotron_tpu.data import dataset as jds
    from self_attention_tacotron_torch.data import dataset as tds
    speakers = [225, 300, 226, 376, 228]
    keys = _write_speaker_corpus(str(tmp_path), speakers)
    hp = vctk_hp(approx_min_target_length=0, batch_bucket_width=64,
                 max_iters=20, average_mel_level_db=[-40.0] * 8,
                 stddev_mel_level_db=[10.0] * 8, source="character")
    files = (tds.find_dataset_files(str(tmp_path), keys, "source.tfrecord"),
             tds.find_dataset_files(str(tmp_path), keys, "target.tfrecord"))
    got = list(tds.dataset_factory(*files, hp, batch_size=2, shuffle=False))
    ref = list(jds.dataset_factory(*files, hp, batch_size=2, shuffle=False))
    assert len(got) == len(ref) == 3
    seen = []
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.speaker_id, r.speaker_id)
        assert g.speaker_id.dtype == np.int32
        mb, jmb = tds.to_model_batch(g), jds.to_model_batch(r)
        np.testing.assert_array_equal(mb.speaker_id.numpy(),
                                      np.asarray(jmb.speaker_id))
        padded, extra = tds.pad_model_batch_rows(mb, 4)
        assert padded.speaker_id.shape[0] == 4 and extra == 4 - len(
            g.speaker_id)
        seen += g.speaker_id.tolist()
    assert sorted(seen) == sorted(speakers)
    u = tds.load_utterance(files[0][3], files[1][3], hp, "mel")
    assert u.speaker_id == 376


def test_speaker_selection_matches_jax(tmp_path, capsys):
    from self_attention_tacotron_tpu.cli import speaker_selection as jsel
    from self_attention_tacotron_torch.cli import speaker_selection as tsel
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    keys = ["p225_001", "p226_002", "p300_003", "p376_004", "p228_005"]
    (tmp_path / "keys.csv").write_text("\n".join(keys) + "\n")
    data = tmp_path / "data"
    data.mkdir()
    for k in keys[::2]:
        (data / f"{k}.source.tfrecord").write_bytes(b"")
    accents = os.path.join(repo, "speaker_selection", "accents.txt")
    selected = os.path.join(repo, "speaker_selection", "Am_Ca_Au_En.txt")
    for args in (["select", str(tmp_path / "keys.csv"), selected],
                 ["accents", accents, "American", "Canadian"],
                 ["crosscheck", str(tmp_path / "keys.csv"), str(data)]):
        outs = []
        for mod, tag in ((jsel, "jax"), (tsel, "torch")):
            out = str(tmp_path / f"{args[0]}.{tag}")
            assert mod.main(args + ["--out", out]) == 0
            outs.append(open(out).read())
        assert outs[0] == outs[1], args[0]
    assert open(str(tmp_path / "crosscheck.torch")).read().split() == \
        keys[::2]
    capsys.readouterr()
