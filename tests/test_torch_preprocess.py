"""The port's preprocessing CLIs beside the JAX package's, on CPU.

On the synthetic LJSpeech and VCTK 0.8 corpora of tests/test_mel_e2e.py
(tones written with scipy, a metadata.csv with numbers for the cleaners,
the VCTK wav48 / txt / speaker-info layout), the port's ``main_ljspeech``,
``main_vctk`` and ``main_ljspeech_wavenet`` run with and without
``--on-device`` (``--device cpu``: the spectrogram kernel's plain version)
beside the JAX package's mains (numpy path; for LJSpeech also its
``--on-device`` path, the Pallas kernel in interpret mode):

* source records byte-identical, ``list.csv`` equal;
* numpy path: mel targets, ``hparams.json`` statistics and the WaveNet
  ``.mfbsp`` dumps equal to the JAX package's bit for bit (the same numpy
  code); ``--on-device``: within the tolerances of tests/test_torch_stft.py
  (magnitude relative to the frame's peak, dB within 60 dB of it),
  statistics within ``TOL_STATS`` dB;
* with ``--on-device``, or ``preprocess_on_device`` from a JSON file, one
  worker process (no pool forks a CUDA context).
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import json
import os

import numpy as np
import pytest

from self_attention_tacotron_torch.data import records as R
from test_mel_e2e import MEL_HPARAMS, ljspeech_corpus, vctk_corpus  # noqa: F401
from test_torch_stft import TOL_DB, TOL_DB_NUMPY, TOL_MAG, db_errors

TOL_STATS = 0.05   # dB: corpus means and deviations, float32 DFT vs numpy
AUDIO_HP = {k: MEL_HPARAMS[k] for k in (
    "sample_rate", "num_freq", "num_mels", "frame_length_ms",
    "frame_shift_ms", "trim_frame_length", "trim_hop_length")}


@pytest.fixture(scope="module")
def hp_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("hp")
    plain, stats, device = d / "hp.json", d / "hp_stats.json", d / "dev.json"
    plain.write_text(json.dumps(AUDIO_HP))
    n = AUDIO_HP["num_mels"]
    stats.write_text(json.dumps(dict(
        AUDIO_HP, average_mel_level_db=list(np.linspace(-60, -20, n)),
        stddev_mel_level_db=list(np.linspace(5, 15, n)))))
    device.write_text(json.dumps(dict(AUDIO_HP, preprocess_on_device=True)))
    return {"plain": str(plain), "stats": str(stats), "device": str(device)}


def _flags(on_device):
    return ["--on-device", "--device", "cpu"] if on_device else []


def _targets(out, keys):
    return [R.parse_mel_target_record(R.read_first_example(
        os.path.join(out, f"{k}.target.tfrecord"))).mel for k in keys]


def _compare(port, ref, keys, exact):
    for k in keys:
        name = f"{k}.source.tfrecord"
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(port, "list.csv")) as a, \
            open(os.path.join(ref, "list.csv")) as b:
        assert a.read() == b.read()
    for got, want in zip(_targets(port, keys), _targets(ref, keys)):
        assert got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got, want)
        else:   # (F, mels) dB re ref_level_db 20
            mag_err, db_err = db_errors(got.T, want.T, 20.0)
            assert mag_err < TOL_MAG and db_err < TOL_DB_NUMPY, (mag_err,
                                                                 db_err)
    with open(os.path.join(port, "hparams.json")) as a, \
            open(os.path.join(ref, "hparams.json")) as b:
        got, want = json.load(a), json.load(b)
    assert got.keys() == want.keys()
    for name in want:
        if exact:
            assert got[name] == want[name], name
        else:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=TOL_STATS, err_msg=name)


@pytest.fixture(scope="module")
def jax_ljspeech(ljspeech_corpus, hp_files, tmp_path_factory):  # noqa: F811
    from self_attention_tacotron_tpu.cli.preprocess import main_ljspeech
    root, _ = ljspeech_corpus
    outs = {}
    for on_device in (False, True):
        out = str(tmp_path_factory.mktemp(f"jax_lj_{on_device}"))
        assert main_ljspeech([str(root), out, "--hparam-json-file",
                              hp_files["plain"], "--num-workers", "1"]
                             + (["--on-device"] if on_device else [])) == 0
        outs[on_device] = out
    return outs


@pytest.mark.parametrize("on_device", [False, True], ids=["numpy", "device"])
def test_ljspeech_matches_jax(ljspeech_corpus, hp_files, jax_ljspeech,  # noqa: F811
                              tmp_path, on_device):
    from self_attention_tacotron_torch.cli.preprocess import main_ljspeech
    root, keys = ljspeech_corpus
    out = str(tmp_path / "port")
    assert main_ljspeech([str(root), out, "--hparam-json-file",
                          hp_files["plain"], "--num-workers", "1"]
                         + _flags(on_device)) == 0
    _compare(out, jax_ljspeech[False], keys, exact=not on_device)
    if on_device:   # both float32 matmul-form DFTs: the tighter dB check
        for got, want in zip(_targets(out, keys),
                             _targets(jax_ljspeech[True], keys)):
            mag_err, db_err = db_errors(got.T, want.T, 20.0)
            assert mag_err < TOL_MAG and db_err < TOL_DB, (mag_err, db_err)


@pytest.mark.parametrize("on_device", [False, True], ids=["numpy", "device"])
def test_vctk_matches_jax(vctk_corpus, hp_files, tmp_path, on_device):  # noqa: F811
    from self_attention_tacotron_torch.cli.preprocess import main_vctk
    from self_attention_tacotron_tpu.cli.preprocess import \
        main_vctk as jax_main_vctk
    root, keys = vctk_corpus
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    common = ["--version", "0.8", "--hparam-json-file", hp_files["plain"],
              "--num-workers", "1"]
    assert jax_main_vctk([str(root), ref, *common]) == 0
    assert main_vctk([str(root), port, *common, *_flags(on_device)]) == 0
    _compare(port, ref, keys, exact=not on_device)


@pytest.mark.parametrize("on_device", [False, True], ids=["numpy", "device"])
def test_ljspeech_wavenet_matches_jax(ljspeech_corpus, hp_files, tmp_path,  # noqa: F811
                                      on_device):
    from self_attention_tacotron_torch.cli.preprocess import \
        main_ljspeech_wavenet
    from self_attention_tacotron_tpu.cli.preprocess import \
        main_ljspeech_wavenet as jax_main
    root, keys = ljspeech_corpus
    dirs = {n: str(tmp_path / n) for n in ("pm", "pw", "jm", "jw")}
    common = ["--hparam-json-file", hp_files["stats"], "--num-workers", "1"]
    assert jax_main([str(root), dirs["jm"], dirs["jw"], *common]) == 0
    assert main_ljspeech_wavenet([str(root), dirs["pm"], dirs["pw"], *common,
                                  *_flags(on_device)]) == 0
    stats = json.load(open(hp_files["stats"]))
    std = np.asarray(stats["stddev_mel_level_db"], np.float32)
    avg = np.asarray(stats["average_mel_level_db"], np.float32)
    for k in keys:
        with open(os.path.join(dirs["pw"], f"{k}.wav"), "rb") as a, \
                open(os.path.join(dirs["jw"], f"{k}.wav"), "rb") as b:
            assert a.read() == b.read()
        got = np.fromfile(os.path.join(dirs["pm"], f"{k}.mfbsp"), "<f4")
        want = np.fromfile(os.path.join(dirs["jm"], f"{k}.mfbsp"), "<f4")
        if not on_device:
            np.testing.assert_array_equal(got, want)
            continue
        n = len(avg)
        got, want = (x.reshape(-1, n) * std + avg for x in (got, want))
        mag_err, db_err = db_errors(got.T, want.T, 20.0)
        assert mag_err < TOL_MAG and db_err < TOL_DB_NUMPY


@pytest.mark.parametrize("how", ["flag", "json", "numpy"])
def test_on_device_forces_one_worker(ljspeech_corpus, hp_files, tmp_path,  # noqa: F811
                                     monkeypatch, how):
    from self_attention_tacotron_torch.cli.preprocess import main_ljspeech
    from self_attention_tacotron_torch.data.preprocess import ljspeech
    seen = []

    def recording_map(fn, items, num_workers=0, ordered=True):
        seen.append(num_workers)
        return [fn(x) for x in items]

    monkeypatch.setattr(ljspeech, "parallel_map", recording_map)
    root, _ = ljspeech_corpus
    argv = [str(root), str(tmp_path / "out"), "--num-workers", "4",
            "--hparam-json-file",
            hp_files["device" if how == "json" else "plain"]]
    if how == "flag":
        argv += ["--on-device", "--device", "cpu"]
    elif how == "json":
        argv += ["--device", "cpu"]
    assert main_ljspeech(argv) == 0
    assert seen == ([4, 4] if how == "numpy" else [1, 1])
