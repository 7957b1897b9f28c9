"""The port's input pipeline against the JAX package's, on CPU.

* The native crc32c (``native/tfrecord_reader.cc``, built by the port at
  first use into ``build/native/``) against the pure-Python table, on
  seeded random bytes.
* The native reader against the pure-Python one on records written by
  the port and by the JAX package; a corrupted record raises in both.
* The port's ``Dataset`` against the JAX package's ``Dataset`` on the same
  files and seeds, batch by batch (keys, shapes, arrays): serial (one
  worker), the worker window, fixed pads (with an utterance skipped), the
  bucket schedule with weights, and the schedule's starvation error.
* ``prefetch()`` against plain iteration, and an error raised through it.
* ``shard_files`` against the JAX package's.
* Targetless (predict-time) batches, ``Dataset(source_files, None, ...)``:
  the port's against the JAX package's, compared exactly, in plain
  iteration, at batch sizes 1 and 2 (one utterance a batch either way),
  with a fixed source pad, the worker window, accent types, a corpus
  that mixes targeted and targetless utterances, and through
  ``prefetch``; the bucket schedule skips targetless utterances in both.
  The first batch through both predict steps, weights carried by
  ``utils/convert``: the JAX package's plain (scan) path against the
  port's fused path, which runs kernels #1 and #2's plain versions on the
  CPU (outputs within 2e-4, alignments within 1e-5).  The forced-alignment
  mode fails on a targetless batch in both.
* An unknown target kind: ``dataset_factory`` takes it, and reading a
  target raises ``ValueError`` naming it, in both.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import itertools
import os

import jax
import numpy as np
import pytest

from self_attention_tacotron_tpu.data import dataset as jds
from self_attention_tacotron_tpu.data import records as JR
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.parallel import \
    make_predict_step as jax_make_predict_step
from self_attention_tacotron_tpu.parallel import multihost as jmh
from self_attention_tacotron_tpu.parallel.train_step import \
    TrainState as JaxTrainState
from self_attention_tacotron_torch.data import dataset as tds
from self_attention_tacotron_torch.data import native_reader
from self_attention_tacotron_torch.data import records as TR
from self_attention_tacotron_torch.data import tfrecord as T
from self_attention_tacotron_torch.models import tacotron_model_factory
from self_attention_tacotron_torch.parallel import make_predict_step
from self_attention_tacotron_torch.parallel import multihost as tmh
from self_attention_tacotron_torch.utils import convert

from test_tacotron_model import tiny_hp
from test_torch_ops import tiny_codes_hp

FIELDS = ("source", "source_length", "target", "target_length", "done",
          "spec_loss_mask", "binary_loss_mask", "speaker_id")


def test_native_crc32c_matches_python():
    assert native_reader.available(), native_reader.unavailable_reason()
    assert native_reader.library_path().parent.name == "native"
    assert T.checksum_in_use() == "native"
    rng = np.random.default_rng(0)
    for n in [0, 1, 7, 8, 9, 63, 64, 65, 1000, 4099]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert native_reader.crc32c_native(data) == T.crc32c_python(data)
        assert T.crc32c(data) == T.crc32c_python(data)
    assert T.crc32c_python(b"123456789") == 0xE3069283


def _corrupt(path, out):
    raw = bytearray(open(path, "rb").read())
    raw[20] ^= 0x55          # inside the payload
    with open(out, "wb") as f:
        f.write(bytes(raw))


def test_native_reader_matches_python_on_both_writers(tmp_path):
    rng = np.random.default_rng(1)
    feats = {"id": T.int64_feature([42, -7, 1 << 40]),
             "key": T.bytes_feature([b"p225_001", b""]),
             "blob": T.bytes_feature([rng.bytes(257)]),
             "vals": T.float_feature([1.5, -2.25, 3.1e-7]),
             "none": T.float_feature([])}
    port = str(tmp_path / "port.tfrecord")
    T.write_example(feats, port)
    jax_src = str(tmp_path / "jax.source.tfrecord")
    JR.write_source_record(JR.SourceRecord(
        id=3, key="p1_001", source=np.array([5, 6, 7], np.int64),
        source_length=3, text="abc", speaker_id=12, age=23, gender=1,
        phone=np.array([1, 2], np.int64), phone_length=2, phone_txt="a b"),
        jax_src, with_phone=True)
    jax_tgt = str(tmp_path / "jax.target.tfrecord")
    JR.write_code_target_record(JR.CodeTargetRecord(
        id=3, key="p1_001", lang="", codes=rng.standard_normal(
            (9, 5)).astype(np.float32), codes_length=9, codes_width=5),
        jax_tgt)
    for path in (port, jax_src, jax_tgt):
        py = next(iter(T.read_examples(path)))
        cc = next(native_reader.read_examples_native(path))
        assert py == cc, path          # kinds and values, exactly
    assert TR.parse_source_record(next(native_reader.read_examples_native(
        jax_src))).key == "p1_001"
    for path in (port, jax_tgt):
        bad = path + ".bad"
        _corrupt(path, bad)
        with pytest.raises(IOError):
            next(iter(T.read_examples(bad)))
        with pytest.raises(IOError):
            next(native_reader.read_examples_native(bad))
        with pytest.raises(IOError):
            tds._read_example(bad)


def write_corpus(hp, root, n=14, seed=0):
    """Codes utterances whose target lengths spread over four buckets."""
    rng = np.random.default_rng(seed)
    keys = []
    for i in range(n):
        key = f"utt{i:03d}"
        L = int(rng.integers(3, 12))
        phone = rng.integers(1, hp.num_symbols, L).astype(np.int64)
        TR.write_source_record(TR.SourceRecord(
            id=i, key=key, source=phone, source_length=L, text=f"u {i}",
            phone=phone, phone_length=L, phone_txt="p", speaker_id=i % 3),
            os.path.join(root, f"{key}.{hp.source_file_extension}"),
            with_phone=True)
        n_codes = int(rng.integers(2, 18))
        codes = np.eye(hp.num_mels, dtype=np.float32)[
            rng.integers(0, hp.num_mels, n_codes)]
        TR.write_code_target_record(TR.CodeTargetRecord(
            id=i, key=key, lang="", codes=codes, codes_length=n_codes,
            codes_width=hp.num_mels),
            os.path.join(root, f"{key}.{hp.target_file_extension}"))
        keys.append(key)
    return keys


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    hp = tiny_hp(approx_min_target_length=4, batch_bucket_width=4,
                 batch_num_buckets=4, max_iters=16, batch_size=2)
    root = str(tmp_path_factory.mktemp("corpus"))
    keys = write_corpus(hp, root)
    files = [tds.find_dataset_files(root, keys, ext) for ext in
             (hp.source_file_extension, hp.target_file_extension)]
    return hp, files


def _same(port_batches, jax_batches):
    assert len(port_batches) == len(jax_batches)
    for p, j in zip(port_batches, jax_batches):
        assert [m.key for m in p.meta] == [m.key for m in j.meta]
        for f in FIELDS:
            a, b = np.asarray(getattr(p, f)), np.asarray(getattr(j, f))
            assert a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


MODES = {
    "serial": dict(num_workers=1),
    "window": dict(num_workers=3, seed=5),
    "fixed_pads": dict(num_workers=2, fixed_target_pad=12,
                       fixed_source_pad=10, drop_remainder=True),
    "schedule": dict(num_workers=2, repeat=True, bucket_schedule_seed=7,
                     bucket_weights=[0.5, 1.0, 2.0],
                     fixed_source_pad=32),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_dataset_matches_jax(corpus, mode):
    hp, files = corpus
    kw = dict(dict(shuffle=True, seed=3), **MODES[mode])
    port = tds.dataset_factory(*files, hp, **kw)
    jax = jds.dataset_factory(*files, hp, **kw)
    take = 9 if kw.get("repeat") else None
    got = list(itertools.islice(port, take))
    ref = list(itertools.islice(jax, take))
    _same(got, ref)
    assert tds.reads["native"] > 0 and tds.reads["python"] == 0
    if mode == "fixed_pads":
        assert all(b.target.shape[1] == 12 and b.source.shape[1] == 10
                   for b in got)
        assert len(got) < 7          # what does not fit is skipped
    if mode == "schedule":
        widths = {b.target.shape[1] for b in got}
        assert widths <= {8, 12, 16} and len(widths) > 1


def test_bucket_schedule_starvation_raises_in_both(corpus):
    """A schedule that draws only bucket 0 (pads of 8) from a shard with no
    utterance that short buffers until the cap, then raises."""
    hp, files = corpus
    long = [(s, t) for s, t in zip(*files)
            if tds.load_utterance(s, t, hp).target_length >= 8]
    src, tgt = [s for s, _ in long], [t for _, t in long]
    kw = dict(repeat=True, bucket_schedule_seed=0,
              bucket_weights=[1.0, 0.0, 0.0], bucket_buffer_cap=6,
              num_workers=2)
    for ds in (tds.dataset_factory(src, tgt, hp, **kw),
               jds.dataset_factory(src, tgt, hp, **kw)):
        with pytest.raises(RuntimeError, match="starvation"):
            next(iter(ds))
    with pytest.raises(RuntimeError, match="starvation"):
        next(tds.dataset_factory(src, tgt, hp, **kw).prefetch())


def test_prefetch_matches_plain_iteration(corpus):
    hp, files = corpus
    ds = tds.dataset_factory(*files, hp, shuffle=True, seed=11,
                             num_workers=2)
    plain = list(ds)
    _same(list(ds.prefetch(buffer_size=2)), plain)
    endless = tds.dataset_factory(*files, hp, repeat=True, num_workers=2)
    it = endless.prefetch()
    first = [next(it) for _ in range(3)]
    it.close()                   # stops the prefetch thread
    _same(first, list(itertools.islice(iter(endless), 3)))


def test_shard_files_matches_jax():
    files = [f"f{i}" for i in range(11)]
    for n in (1, 2, 3, 4):
        shards = [tmh.shard_files(files, r, n) for r in range(n)]
        assert shards == [jmh.shard_files(files, r, n) for r in range(n)]
        assert sorted(sum(shards, [])) == sorted(files)
    assert tmh.local_batch_size(32, 2) == 16
    with pytest.raises(ValueError, match="32 must divide evenly over 3"):
        tmh.local_batch_size(32, 3)


# ------------------------------------------------ targetless (predict time)

TOL_OUTPUTS, TOL_ALIGNMENTS = 2e-4, 1e-5     # test_torch_model_surface's
SOURCE_FIELDS = ("source", "source_length", "target_length", "speaker_id",
                 "accent_type")
TARGET_FIELDS = ("target", "target2", "done", "spec_loss_mask",
                 "binary_loss_mask")


@pytest.fixture(scope="module")
def targetless(tmp_path_factory):
    """The codes recipe's mechanisms at tiny widths (the predict steps run
    on it) over a corpus of 8 utterances of 3-11 phones."""
    hp = tiny_codes_hp(approx_min_target_length=4, batch_bucket_width=4,
                       batch_num_buckets=4, max_iters=16, batch_size=2)
    root = str(tmp_path_factory.mktemp("targetless"))
    keys = write_corpus(hp, root, n=8, seed=4)
    files = [tds.find_dataset_files(root, keys, ext) for ext in
             (hp.source_file_extension, hp.target_file_extension)]
    return hp, files


def _same_targetless(port_batches, jax_batches):
    """Exactly the same batches; where the JAX batch has no target, the
    port's has none either."""
    assert len(port_batches) == len(jax_batches)
    for p, j in zip(port_batches, jax_batches):
        assert [m.key for m in p.meta] == [m.key for m in j.meta]
        for f in SOURCE_FIELDS + TARGET_FIELDS:
            a, b = getattr(p, f), getattr(j, f)
            if b is None:
                assert a is None, f
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


TARGETLESS = {
    "plain": dict(),
    "batch_size_1": dict(batch_size=1),
    "batch_size_2": dict(batch_size=2, num_workers=1),
    "fixed_source_pad": dict(fixed_source_pad=8, num_workers=2),
    "window": dict(num_workers=3, shuffle=True, seed=5),
    "accent_type": dict(use_accent_type=True),
    "mixed": dict(mixed=True),
    "prefetch": dict(prefetch=True, num_workers=2),
}


@pytest.mark.parametrize("mode", list(TARGETLESS))
def test_targetless_dataset_matches_jax(targetless, mode):
    hp, (src, tgt) = targetless
    kw = dict(dict(shuffle=False), **TARGETLESS[mode])
    if kw.pop("use_accent_type", False):
        hp = hp.replace(use_accent_type=True)
    targets = ([t if i % 2 else None for i, t in enumerate(tgt)]
               if kw.pop("mixed", False) else None)
    prefetch = kw.pop("prefetch", False)
    port = tds.dataset_factory(src, targets, hp, **kw)
    ref = list(jds.dataset_factory(src, targets, hp, **kw))
    got = list(port.prefetch(buffer_size=2) if prefetch else port)
    _same_targetless(got, ref)
    alone = [b for b in got if b.target is None]
    assert len(alone) == (4 if targets else len(got))
    for b in alone:              # each a batch of its own, its source
        assert b.source.shape[0] == 1     # pad rounded up
        assert b.source.shape[1] == kw.get("fixed_source_pad", 32)
        assert not b.target_length.any()
    if "fixed_source_pad" in kw:
        assert 0 < len(got) < len(src)    # longer sources are skipped
    if hp.use_accent_type:
        assert (got[0].accent_type == hp.accent_type_unknown).all()


def test_bucket_schedule_skips_targetless_utterances(targetless):
    hp, (src, tgt) = targetless
    kw = dict(shuffle=False, bucket_schedule_seed=3, num_workers=2,
              fixed_source_pad=32)
    for ds in (tds.dataset_factory, jds.dataset_factory):
        assert list(ds(src, None, hp, **kw)) == []
    mixed = [t if i % 2 else None for i, t in enumerate(tgt)]
    kw.update(repeat=True, batch_size=1)
    got = list(itertools.islice(tds.dataset_factory(src, mixed, hp, **kw),
                                6))
    _same(got, list(itertools.islice(jds.dataset_factory(src, mixed, hp,
                                                         **kw), 6)))
    assert len(got) == 6 and all(b.target is not None for b in got)
    assert {m.key for b in got for m in b.meta} <= {
        os.path.basename(s).split(".")[0] for s in src[1::2]}


def test_targetless_batch_serves_as_jax_does(targetless):
    """The first targetless batch through both predict steps."""
    hp, (src, _) = targetless
    port_hp = hp.replace(decoder_fused_inference=True,
                         encoder_fused_inference=True)
    jax_hp = hp.replace(decoder_fused_inference=False,
                        encoder_fused_inference=False)
    model = convert.init_parameters(tacotron_model_factory(port_hp),
                                    seed=1).eval()
    v = convert.to_flax(model.state_dict(), model)
    state = JaxTrainState(step=0, params=v["params"],
                          batch_stats=v["batch_stats"], constants={},
                          opt_state=None)
    nb = next(iter(tds.Dataset(src, None, hp, shuffle=False)))
    jnb = next(iter(jds.Dataset(src, None, hp, shuffle=False)))
    batch = tds.to_model_batch(nb)
    assert batch.target is None and batch.done is None
    padded, added = tds.pad_model_batch_rows(batch, 2)   # None stays None
    assert added == 1 and padded.source.shape[0] == 2
    assert padded.target is None and padded.spec_loss_mask is None
    (got,) = make_predict_step(port_hp)(model, batch)
    ref = jax.tree_util.tree_map(np.asarray, jax_make_predict_step(
        jax_factory(jax_hp), jax_hp)(state, jds.to_model_batch(jnb)))
    np.testing.assert_allclose(got.outputs.numpy(), ref.outputs, rtol=0,
                               atol=TOL_OUTPUTS)
    for g, r in zip(got.alignments, ref.alignments):
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=TOL_ALIGNMENTS)
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)
    # the forced-alignment mode decodes the target's steps again: without
    # a target the port refuses the batch, the JAX package's VALIDATION
    # pass fails reading the target's shape
    forced = hp.replace(use_forced_alignment_mode=True)
    with pytest.raises(ValueError, match="needs its target"):
        make_predict_step(forced)(model, batch)
    with pytest.raises(AttributeError, match="shape"):
        jax_make_predict_step(jax_factory(forced.replace(
            decoder_fused_inference=False, encoder_fused_inference=False)),
            forced)(state, jds.to_model_batch(jnb))


def test_unknown_target_kind_raises_as_jax_does(targetless):
    hp, (src, tgt) = targetless
    for ds in (tds.dataset_factory, jds.dataset_factory):
        assert len(list(ds(src[:2], None, hp, target_kind="wav"))) == 2
        with pytest.raises(ValueError, match="^wav$"):
            list(ds(src[:2], tgt[:2], hp, target_kind="wav",
                    num_workers=1))
