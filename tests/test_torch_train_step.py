"""The port's training against the JAX package on CPU.

* The whole codes model in TRAIN mode (forward attention with the recipe's
  even K = 10 location conv, decoder v2, dropout and zoneout off as in
  tests/test_fused_train.py's forward-attention case): loss, outputs,
  updated batch statistics and every gradient leaf by flax path against
  JAX ``compute_loss`` and ``jax.grad``, on the plain trunk and on the
  fused one (whose plain version runs on CPU).  Tolerances as there: loss
  rtol 1e-5, outputs rtol 2e-4 / atol 2e-5, gradients rtol 2e-3 / atol
  2e-5.
* A 3-step loss and parameter trajectory of ``make_train_step`` against
  the JAX package's (clip 1.0, Adam, noam decay).
* Checkpoint retention, resume and ``warm_start``.
* ``cli.train --device cpu`` on a tiny synthetic corpus, then
  ``cli.predict`` from the checkpoint it wrote.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import DecoderMode
from self_attention_tacotron_tpu.models import compute_loss as jax_loss
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_torch.models import (Batch, compute_loss,
                                                  tacotron_model_factory)
from self_attention_tacotron_torch.utils import convert

from test_tacotron_model import make_batch, tiny_hp
from test_torch_ops import jit_create_state, jit_init, np_tree

DET = dict(encoder_prenet_drop_rate=0.0, decoder_prenet_drop_rate=0.0,
           self_attention_drop_rate=0.0, decoder_self_attention_drop_rate=0.0,
           zoneout_factor_cell=0.0, zoneout_factor_output=0.0,
           attention="forward", cumulative_weights=False, attention_kernel=10,
           attention_filters=5, decoder_version="v2")


def train_hp(**kw):
    return tiny_hp(**dict(DET, **kw))


def port_batch(jb) -> Batch:
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Batch(source=t(jb.source), source_length=t(jb.source_length),
                 target=t(jb.target), target_length=t(jb.target_length),
                 done=t(jb.done), spec_loss_mask=t(jb.spec_loss_mask),
                 binary_loss_mask=t(jb.binary_loss_mask))


@functools.lru_cache(maxsize=None)
def _jax_case():
    hp = train_hp()
    batch = make_batch(hp, B=2, T_in=7, T_out=6)
    model = jax_factory(hp)
    v = jit_init(model, {"params": jax.random.PRNGKey(0)}, batch,
                 mode=DecoderMode.VALIDATION, teacher_forcing=True)
    v = np_tree(v)
    # non-trivial running statistics, so that the update is visible
    rng = np.random.default_rng(3)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        v["batch_stats"])

    def loss(params):
        out, mut = model.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, batch,
                               DecoderMode.TRAIN,
                               rngs={"dropout": jax.random.PRNGKey(1),
                                     "zoneout": jax.random.PRNGKey(2)},
                               mutable=["batch_stats"])
        return jax_loss(hp, out, batch, params)["loss"], (out, mut)

    (l, (out, mut)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    return (v, batch, float(l), np.asarray(out.outputs),
            np_tree(mut["batch_stats"]), np_tree(g))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_ref"])
def test_train_loss_outputs_and_gradients_match_jax(fused):
    v, jb, l_ref, out_ref, stats_ref, g_ref = _jax_case()
    model = tacotron_model_factory(train_hp(decoder_fused_train=fused))
    model.load_state_dict(convert.from_flax(v), strict=True)
    model.train()
    batch = port_batch(jb)
    out = model.train_forward(batch)
    losses = compute_loss(model.hp, out, batch, model)
    losses["loss"].backward()
    np.testing.assert_allclose(float(losses["loss"].detach()), l_ref,
                               rtol=1e-5)
    np.testing.assert_allclose(out.outputs.detach().numpy(), out_ref,
                               rtol=2e-4, atol=2e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    got = _flat(convert.to_flax(grads, model)["params"])
    ref = _flat(g_ref)
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=2e-3,
                                   atol=2e-5, err_msg=name)
    loc = [n for n in ref if "location" in n]
    assert len(loc) >= 3 and all(np.abs(ref[n]).max() > 0 for n in loc)
    stats = _flat(convert.to_flax(model.state_dict(), model)["batch_stats"])
    for name, x in _flat(stats_ref).items():
        np.testing.assert_allclose(stats[name], x, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _adam_step_bound(beta1: float, beta2: float, t: int) -> float:
    """The most one Adam update (t counted from 1) moves a parameter, over
    the learning rate: |m_hat| / sqrt(v_hat) <= sqrt(sum_i w_i^2 / u_i) by
    Cauchy-Schwarz, where w_i and u_i are the bias-corrected moments'
    weights of the gradients g_1..g_t (each set sums to 1); eps only
    lowers it.  1 at t = 1, 1.0014 at t = 2 for (0.9, 0.999)."""
    w = [(1 - beta1) * beta1 ** (t - i) / (1 - beta1 ** t)
         for i in range(1, t + 1)]
    u = [(1 - beta2) * beta2 ** (t - i) / (1 - beta2 ** t)
         for i in range(1, t + 1)]
    return float(np.sqrt(sum(a * a / b for a, b in zip(w, u))))


def test_three_step_trajectory_matches_jax_make_train_step():
    """Losses, metrics and parameters after each of 3 updates.  The
    initial rate 8.0 makes noam(0..2) = 0.002, 0.004, 0.006, so that the
    updates move the parameters visibly.

    The key projections' biases of the two self-attention layers are held
    differently.  A softmax attention's key bias adds the same q . b to
    every score of a query, which the softmax removes, so their exact
    gradient is zero: both packages move them by rounding noise only,
    which Adam normalises to steps of up to the learning rate, in an order
    that depends on the machine.  For them the test asserts the property
    itself (the port's first-batch gradient is <= 1e-6 of the largest
    gradient) and that both packages leave them within the most 3 Adam
    steps can move a parameter (sum of lr_t times ``_adam_step_bound``) of
    their initial values; every other leaf is compared elementwise."""
    from self_attention_tacotron_tpu.parallel.train_step import \
        make_train_step as jax_make
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    hp = train_hp(initial_learning_rate=8.0)
    batches = [make_batch(hp, B=2, T_in=7, T_out=6, seed=s) for s in range(3)]
    model = jax_factory(hp)
    # jitted (one compile, not one an operation): the eager state
    jstate = jit_create_state(model, hp, batches[0], jax.random.PRNGKey(0))
    init = np_tree({"params": jstate.params,
                    "batch_stats": jstate.batch_stats})
    port = tacotron_model_factory(hp)
    port.load_state_dict(convert.from_flax(init))
    key_bias = [n for n in _flat(init["params"])
                if "key_projection" in n and "bias" in n]
    assert len(key_bias) == 2, key_bias

    probe = tacotron_model_factory(hp)
    probe.load_state_dict(port.state_dict())
    probe.train()
    first = port_batch(batches[0])
    compute_loss(hp, probe.train_forward(first), first,
                 probe)["loss"].backward()
    grads = _flat(convert.to_flax({k: p.grad for k, p in
                                   probe.named_parameters()},
                                  probe)["params"])
    largest = max(float(np.abs(g).max()) for g in grads.values())
    for name in key_bias:
        assert np.abs(grads[name]).max() <= 1e-6 * largest, name

    state = create_train_state(port, hp)
    jstep, step = jax_make(model, hp, donate=False), make_train_step(hp)
    moved = 0.0
    for t, jb in enumerate(batches, 1):
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(5))
        m = step(state, port_batch(jb))
        for k in ("loss", "code_loss", "done_loss", "learning_rate",
                  "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
        moved += float(m["learning_rate"]) * _adam_step_bound(
            hp.adam_beta1, hp.adam_beta2, t)
    assert state.step == int(jstate.step) == 3
    got = convert.to_flax(port.state_dict(), port)
    ref = np_tree({"params": jstate.params,
                   "batch_stats": jstate.batch_stats})
    for coll in ("params", "batch_stats"):
        g, r = _flat(got[coll]), _flat(ref[coll])
        assert g.keys() == r.keys()
        for name in r:
            if name in key_bias and coll == "params":
                start = _flat(init["params"])[name]
                for side in (g, r):
                    assert np.abs(side[name] - start).max() <= moved, name
                continue
            np.testing.assert_allclose(g[name], r[name], rtol=1e-4,
                                       atol=2e-5, err_msg=name)


def test_checkpoint_retention_resume_and_warm_start(tmp_path):
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    from self_attention_tacotron_torch.utils.checkpoint import (
        CheckpointManager, warm_start)
    hp = train_hp(initial_learning_rate=8.0)
    batch = port_batch(make_batch(hp, B=2, T_in=7, T_out=6))
    step = make_train_step(hp)
    ckpt = CheckpointManager(str(tmp_path / "a"), save_interval_steps=2,
                             max_to_keep=2)
    state = create_train_state(
        convert.init_parameters(tacotron_model_factory(hp), 1), hp)
    saved = []
    for _ in range(6):
        step(state, batch)
        saved.append(ckpt.save(state.step, state))
    assert saved == [False, True, False, True, False, True]
    assert ckpt.all_steps() == [4, 6]
    assert not ckpt.save(6, state, force=True)     # already there
    assert sorted(os.listdir(tmp_path / "a")) == [
        "model-4.pt", "model-6.pt", "train-4.pt", "train-6.pt"]
    # resume: the restored run's next update equals the unbroken run's
    resumed = create_train_state(
        convert.init_parameters(tacotron_model_factory(hp), 2), hp)
    assert ckpt.restore(resumed) == 6 and resumed.step == 6
    m_a, m_b = step(state, batch), step(resumed, batch)
    np.testing.assert_allclose(float(m_b["loss"]), float(m_a["loss"]),
                               rtol=1e-6)
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=k)
    # the checkpoint serves: cli/predict restores model-<step>.pt
    served = tacotron_model_factory(hp)
    assert convert.load_checkpoint(served, str(tmp_path / "a")) == 6
    # warm start copies the matching flax paths only
    fresh = convert.init_parameters(tacotron_model_factory(hp), 9)
    before = dict(convert.flax_param_paths(fresh))
    before = {k: v.detach().clone() for k, v in before.items()}
    copied = warm_start(fresh, str(tmp_path / "a"), [r"^decoder/"])
    assert copied and all(p.startswith("decoder/") for p in copied)
    now = dict(convert.flax_param_paths(fresh))
    ref = dict(convert.flax_param_paths(served))
    for path, p in now.items():
        want = ref[path] if path.startswith("decoder/") else before[path]
        torch.testing.assert_close(p.detach(), want.detach(), msg=path)


def write_codes_corpus(hp, root, n, lengths=(5, 9), seed=0):
    """A synthetic codes corpus: phone-id sources and one-hot targets,
    with train.csv and test.csv key lists."""
    from self_attention_tacotron_torch.data.records import (
        CodeTargetRecord, SourceRecord, write_code_target_record,
        write_source_record)
    rng = np.random.default_rng(seed)
    keys = []
    for i in range(n):
        key = f"utt{i:03d}"
        L = int(rng.integers(3, 9))
        phone = rng.integers(1, hp.num_symbols, L).astype(np.int64)
        write_source_record(SourceRecord(
            id=i, key=key, source=phone, source_length=L, text=f"utt {i}",
            phone=phone, phone_length=L, phone_txt=" ".join(map(str, phone))),
            os.path.join(root, f"{key}.{hp.source_file_extension}"),
            with_phone=True)
        n_codes = int(rng.integers(*lengths))
        codes = np.eye(hp.num_mels, dtype=np.float32)[
            rng.integers(0, hp.num_mels, n_codes)]
        write_code_target_record(CodeTargetRecord(
            id=i, key=key, lang="", codes=codes, codes_length=n_codes,
            codes_width=hp.num_mels),
            os.path.join(root, f"{key}.{hp.target_file_extension}"))
        keys.append(key)
    for name in ("train.csv", "test.csv"):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(keys) + "\n")
    return keys


def test_dataset_buckets_pads_and_pads_rows(tmp_path):
    from self_attention_tacotron_torch.data import dataset as ds
    hp = train_hp(approx_min_target_length=4, batch_bucket_width=4,
                  batch_num_buckets=3, max_iters=9, batch_size=2)
    keys = write_codes_corpus(hp, str(tmp_path), 9, lengths=(3, 12))
    files = [ds.find_dataset_files(str(tmp_path), keys, ext) for ext in
             (hp.source_file_extension, hp.target_file_extension)]
    batches = list(ds.dataset_factory(*files, hp, shuffle=False))
    bk = ds.Bucketing(hp)
    n_rows = 0
    for nb in batches:
        bid = bk.bucket_id(int(nb.target_length.max()))
        assert nb.target.shape[1] == bk.target_pad_length(bid)
        assert nb.source.shape[1] % 32 == 0
        for i, L in enumerate(nb.target_length):
            assert bk.bucket_id(int(L)) == bid
            assert nb.spec_loss_mask[i].sum() == L
            assert nb.done[i, L - 1] == 1 and nb.done[i, :L - 1].sum() == 0
            assert (nb.done[i, L:] == 1).all()
        n_rows += len(nb.meta)
    assert n_rows == sum(1 for k in keys if ds.load_utterance(
        os.path.join(str(tmp_path), f"{k}.{hp.source_file_extension}"),
        os.path.join(str(tmp_path), f"{k}.{hp.target_file_extension}"),
        hp).target_length <= hp.max_iters)
    full = list(ds.dataset_factory(*files, hp, shuffle=True, seed=3,
                                   drop_remainder=True))
    assert all(len(nb.meta) == 2 for nb in full)
    mb = ds.to_model_batch(batches[0])
    padded, extra = ds.pad_model_batch_rows(mb._replace(
        source=mb.source[:1], source_length=mb.source_length[:1],
        target=mb.target[:1], target_length=mb.target_length[:1],
        done=mb.done[:1], spec_loss_mask=mb.spec_loss_mask[:1],
        binary_loss_mask=mb.binary_loss_mask[:1]), 4)
    assert extra == 3 and padded.source.shape[0] == 4
    assert float(padded.spec_loss_mask[1:].sum()) == 0
    assert torch.equal(padded.target[3], padded.target[0])


def test_cli_train_on_cpu_then_predict_from_its_checkpoint(tmp_path, capsys):
    import json
    from self_attention_tacotron_torch.cli.predict import main_code
    from self_attention_tacotron_torch.cli.train import main
    from self_attention_tacotron_torch.ops import fused_train as ft
    tiny = dict(num_symbols=30, embedding_dim=16, num_mels=10,
                cbhg_out_units=16, conv_channels=8, max_filter_width=4,
                projection1_out_channels=8, projection2_out_channels=8,
                encoder_prenet_out_units=[16, 8], self_attention_out_units=8,
                attention1_out_units=8, attention2_out_units=8,
                attention_out_units=12, decoder_prenet_out_units=[8, 4],
                decoder_out_units=16, decoder_self_attention_out_units=16,
                max_iters=12, decoder_min_iters=1, batch_size=2,
                approx_min_target_length=0, batch_bucket_width=16,
                save_checkpoints_steps=2, keep_checkpoint_max=2,
                attention_kernel=4, decoder_version="v2",
                decoder_fused_train=True, decoder_fused_inference=True,
                encoder_fused_inference=True)
    recipe = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "codes",
        "self-attention-tacotron.json")
    with open(recipe) as f:
        hp_json = dict(json.load(f), **tiny)
    (tmp_path / "hp.json").write_text(json.dumps(hp_json))
    from self_attention_tacotron_torch.config import load_hparams
    hp = load_hparams(type("A", (), {"hparam_json_file": str(
        tmp_path / "hp.json"), "hparams": ""}))
    data, ckpt, out = (str(tmp_path / d) for d in ("data", "ckpt", "out"))
    os.makedirs(data)
    keys = write_codes_corpus(hp, data, 6)
    common = ["--source-data-root", data, "--target-data-root", data,
              "--checkpoint-dir", ckpt, "--hparam-json-file",
              str(tmp_path / "hp.json"), "--device", "cpu"]
    launches = ft.fused_train_fwd.launches
    assert main(common + ["--max-steps", "3"]) == 0
    assert ft.fused_train_fwd.launches == launches   # CPU: plain version
    text = capsys.readouterr().out
    logged = [line for line in text.splitlines() if " loss " in line]
    assert [line.split("step ")[1].split()[0] for line in logged] == [
        "1", "2", "3"]
    assert "not ported yet" not in text       # the plots and the profiler
    assert "evaluation is off" in text        # no validation.csv
    files = sorted(os.listdir(ckpt))
    assert [f for f in files if not f.startswith("events.out")] == [
        "alignments", "eval", "log.txt", "metrics.jsonl", "model-2.pt",
        "model-3.pt", "train-2.pt", "train-3.pt"]
    # alignment_save_steps (50) did not fire in 3 steps, nor an evaluation
    assert os.listdir(os.path.join(ckpt, "alignments")) == []
    assert os.listdir(os.path.join(ckpt, "eval")) == []
    # resume and take one more step
    assert main(common + ["--max-steps", "4"]) == 0
    text = capsys.readouterr().out
    assert "resumed from step 3" in text and "step 4 loss" in text
    assert main_code(["--source-data-root", data, "--target-data-root", data,
                      "--checkpoint-dir", ckpt, "--output-dir", out,
                      "--hparam-json-file", str(tmp_path / "hp.json"),
                      "--device", "cpu", "--limit", "2"]) == 0
    assert sum(f.endswith(".tfrecord") for f in os.listdir(out)) == 2
    assert keys
