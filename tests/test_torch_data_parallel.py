"""The port's data-parallel training on CPU: two gloo processes.

* One deterministic step (dropout off, zoneout off) on 2 ranks against the
  port's one-process step on the concatenated batch and against the JAX
  package's ``make_train_step(model, hp, mesh=<2-device CPU mesh>)`` with
  the same weights.  The global batch holds 3 rows of unequal target
  lengths and one padded remainder row (``pad_model_batch_rows``: a copy
  of the last row with empty loss masks), so that the two ranks' valid
  frame counts differ (11 against 3): a per-rank mean of the losses, or
  per-rank batch-norm statistics, would be off.  Both at the recipe's
  schedule (5e-7 at update 0) and at a rate of 0.002, in one spawn.
  Against the one-process step: the gradients, the batch-norm running
  statistics and the parameters within 1e-6 of the largest magnitude
  among them (the parameters at 0.002 within 1e-5:
  ``test_two_rank_step_matches_one_process_step``'s docstring says why),
  each tensor within 1e-4 of its own largest magnitude (the attention
  layers' gradients are ~1e-5 of the largest, so their rounding is larger
  against their own scale), the loss and the gradient norm within 1e-6
  relative, the ranks' states identical; the key projections' biases,
  whose exact gradient is zero, are held as in
  ``tests/test_torch_train_step.py``.  Against the JAX package at 0.002:
  that file's tolerances.
* The fused trunk's seed on rank r is the drawn seed + 40507 r.
* ``cli.train --num-processes 2 --device cpu`` for 2 steps: one
  checkpoint, ``metrics.jsonl`` from rank 0 only, a ``.p1`` log with the
  same global losses.
* A 2-D ``mesh_shape`` and a batch that does not divide over the ranks
  are refused, each with its reason.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from self_attention_tacotron_torch import entry
from self_attention_tacotron_torch.data.dataset import pad_model_batch_rows
from self_attention_tacotron_torch.models import tacotron_model_factory
from self_attention_tacotron_torch.parallel.train_step import learning_rate
from self_attention_tacotron_torch.utils import convert

from test_tacotron_model import make_batch
from test_torch_ops import jit_create_state, np_tree
from test_torch_train_step import (_adam_step_bound, _flat, port_batch,
                                   train_hp, write_codes_corpus)

LENGTHS = (6, 5, 3)


def dp_hp(**kw):
    return train_hp(**kw)


def global_batch(hp):
    """3 rows of target lengths 6, 5, 3 and a padded fourth row."""
    jb = make_batch(hp, B=3, T_in=7, T_out=6, seed=4)
    b = port_batch(jb)
    lengths = torch.tensor(LENGTHS)
    steps = torch.arange(6)[None]
    spec = (steps < lengths[:, None]).float()
    b = b._replace(target_length=lengths, spec_loss_mask=spec,
                   binary_loss_mask=spec.clone(),
                   done=(steps >= lengths[:, None] - 1).float(),
                   speaker_id=torch.zeros(3, dtype=torch.int32))
    padded, extra = pad_model_batch_rows(b, 4)
    assert extra == 1
    return padded


# the recipe's schedule (noam at update 0: 5e-7) and a rate of 0.002 whose
# update moves the parameters visibly (tests/test_torch_train_step.py's)
RATES = {"schedule": {}, "visible": {"initial_learning_rate": 8.0}}


@functools.lru_cache(maxsize=None)
def _steps():
    """One spawn of 2 ranks for both rates; the one-process steps."""
    cases = [(dp_hp(**kw), global_batch(dp_hp(**kw))) for kw in
             RATES.values()]
    ranked = entry.data_parallel_steps(cases, 2, "cpu")
    return {name: (hp, batch, ranks, entry.single_process_step(
        hp, batch, "cpu")) for name, (hp, batch), ranks in
        zip(RATES, cases, ranked)}


@pytest.mark.parametrize("rate", list(RATES))
def test_two_rank_step_matches_one_process_step(rate):
    """At the schedule's rate everything within 1e-6 of its collection's
    largest magnitude.  At 0.002 the parameters within 1e-5: Adam's first
    update divides each gradient by its magnitude + 1e-8, so an element
    whose gradient is near 1e-8 moves by a sizeable share of the rate, and
    there the ranks' summation order (2e-7 of the largest gradient, as at
    the schedule's rate) shows 1.8e-6 of the largest parameter."""
    hp, batch, ranks, single = _steps()[rate]
    assert [float(r["metrics"]["loss"]) for r in ranks] == \
        [ranks[0]["metrics"]["loss"]] * 2
    errs = entry.step_errors(single, ranks, learning_rate(hp, 0))
    assert errs["ranks_identical"] and errs["noise_ok"], errs
    assert [k.split(".")[-2] for k in errs["noise"]] == ["key_projection"] * 2
    for k in ("params", "grads", "stats"):
        bound = 1e-5 if (k, rate) == ("params", "visible") else 1e-6
        assert errs[k + "_global"] <= bound, (k, errs)
        assert errs[k] <= 1e-4, (k, errs)
    assert errs["loss"] <= 1e-6 and errs["grad_norm"] <= 1e-6, errs
    # the valid counts differ between the halves: 11 frames against 3
    valid = batch.spec_loss_mask.sum(1)
    assert float(valid[:2].sum()) == 11 and float(valid[2:].sum()) == 3


def test_two_rank_step_matches_jax_mesh_step():
    from jax.sharding import Mesh

    from self_attention_tacotron_tpu.models import \
        tacotron_model_factory as jax_factory
    from self_attention_tacotron_tpu.parallel.mesh import (
        replicated_sharding, shard_batch)
    from self_attention_tacotron_tpu.parallel.train_step import \
        make_train_step as jax_make
    from self_attention_tacotron_tpu.models import Batch as JBatch
    hp, batch, ranks, single = _steps()["visible"]
    port = tacotron_model_factory(hp)
    port.load_state_dict(single["before"])
    init = convert.to_flax(single["before"], port)
    jb = JBatch(**{k: (None if v is None else jax.numpy.asarray(v.numpy()))
                   for k, v in batch._asdict().items()})
    model = jax_factory(hp)
    # jitted (one compile, not one an operation); only the optimizer
    # state is kept
    jstate = jit_create_state(model, hp, jb, jax.random.PRNGKey(0))
    jstate = jstate._replace(params=init["params"],
                             batch_stats=init["batch_stats"])
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    jstate = jax.device_put(jstate, replicated_sharding(mesh))
    jstate, jm = jax_make(model, hp, mesh=mesh, donate=False)(
        jstate, shard_batch(jb, mesh), jax.random.PRNGKey(5))
    m = ranks[1]["metrics"]
    for k in ("loss", "code_loss", "done_loss", "learning_rate",
              "grad_norm"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4, err_msg=k)
    got = convert.to_flax(ranks[1]["after"], port)
    ref = np_tree({"params": jstate.params,
                   "batch_stats": jstate.batch_stats})
    start = _flat(init["params"])
    moved = float(m["learning_rate"]) * _adam_step_bound(
        hp.adam_beta1, hp.adam_beta2, 1)
    for coll in ("params", "batch_stats"):
        g, r = _flat(got[coll]), _flat(ref[coll])
        assert g.keys() == r.keys()
        for name in r:
            if coll == "params" and "key_projection" in name \
                    and "bias" in name:
                for side in (g, r):
                    assert np.abs(side[name] - start[name]).max() \
                        <= moved * (1 + 1e-3), name
                continue
            np.testing.assert_allclose(
                g[name], r[name], rtol=1e-4 if coll == "params" else 1e-5,
                atol=2e-5 if coll == "params" else 1e-6, err_msg=name)


class _Rank:
    """A one-rank stand-in for ``ops.collectives.DataAxis`` that reports
    rank r (its sums are the identity)."""

    def __init__(self, rank):
        self.rank, self.size = rank, 1

    def all_reduce_(self, x):
        return x

    def all_reduce(self, x):
        return x


def test_fused_trunk_seed_is_offset_by_rank(monkeypatch):
    from self_attention_tacotron_torch.ops import collectives
    from self_attention_tacotron_torch.ops import fused_train as ft
    from self_attention_tacotron_torch.parallel.train_step import \
        step_generator
    hp = train_hp(decoder_fused_train=True)
    model = convert.init_parameters(tacotron_model_factory(hp), 0).train()
    batch = port_batch(make_batch(hp, B=2, T_in=7, T_out=6))
    seeds = []
    scan = ft.fused_teacher_scan
    monkeypatch.setattr(ft, "fused_teacher_scan",
                        lambda *a, **k: seeds.append(a[5]) or scan(*a, **k))
    for rank in (0, 1, 3):
        with collectives.data_axis(_Rank(rank)):
            model.train_forward(batch, step_generator(hp, 2, "cpu"))
    assert seeds[1] - seeds[0] == 40507 and seeds[2] - seeds[0] == 3 * 40507
    # each rank draws from its own stream; rank 0's is the one-process one
    draws = [torch.rand(4, generator=step_generator(hp, 2, "cpu", r))
             for r in (0, 1)]
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(draws[0], torch.rand(
        4, generator=step_generator(hp, 2, "cpu")))


def test_cli_train_on_two_processes(tmp_path):
    from self_attention_tacotron_torch.cli.train import main
    hp = dp_hp()
    data = str(tmp_path / "data")
    os.makedirs(data)
    write_codes_corpus(hp, data, 12, lengths=(3, 6))
    ckpt = str(tmp_path / "ckpt")
    tiny = ",".join(f"{k}={v}" for k, v in dict(
        num_symbols=30, embedding_dim=16, num_mels=10, cbhg_out_units=16,
        conv_channels=8, max_filter_width=4, projection1_out_channels=8,
        projection2_out_channels=8, self_attention_out_units=8,
        self_attention_num_heads=2, attention1_out_units=8,
        attention2_out_units=8, attention_out_units=12,
        decoder_out_units=16, decoder_self_attention_out_units=16,
        max_iters=6, batch_size=4, approx_min_target_length=2,
        batch_bucket_width=2, batch_num_buckets=3,
        multihost_source_pad_length=16, outputs_per_step=1,
        n_feed_frame=1, decoder_fused_train="true").items())
    tiny += (",encoder_prenet_out_units=[16,8],"
             "decoder_prenet_out_units=[8,4]")
    rc = main(["--source-data-root", data, "--target-data-root", data,
               "--checkpoint-dir", ckpt, "--hparam-json-file",
               os.path.join(os.path.dirname(__file__), "..", "examples",
                            "codes", "self-attention-tacotron.json"),
               "--hparams", tiny, "--max-steps", "2", "--device", "cpu",
               "--num-processes", "2"])
    assert rc == 0
    files = sorted(os.listdir(ckpt))
    assert [f for f in files if f.endswith(".pt")] == ["model-2.pt",
                                                       "train-2.pt"]
    assert "log.txt" in files and "log.txt.p1" in files
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    losses = []
    for name in ("log.txt", "log.txt.p1"):
        with open(os.path.join(ckpt, name)) as f:
            text = f.read()
        losses.append(re.findall(r"step \d+ loss ([-0-9.]+)", text))
        assert "backend gloo" in text and "TFRecord reader: native" in text
    assert len(losses[0]) == 2 and losses[0] == losses[1]


def test_mesh_shape_and_indivisible_batch_are_refused(tmp_path):
    from self_attention_tacotron_torch.cli.train import main
    from self_attention_tacotron_torch.parallel.mesh import (
        check_mesh_shape, create_mesh)
    args = ["--source-data-root", str(tmp_path), "--target-data-root",
            str(tmp_path), "--checkpoint-dir", str(tmp_path / "c"),
            "--device", "cpu", "--num-processes", "2"]
    with pytest.raises(ValueError, match=r"batch_size 5 must divide "
                       r"evenly over 2 processes"):
        main(args + ["--hparams", "batch_size=5"])
    with pytest.raises(ValueError, match=r"hp.mesh_shape=\(2, 1\).*one "
                       r"data axis"):
        main(args + ["--hparams", "mesh_shape=[2,1]"])
    with pytest.raises(ValueError, match=r"does not match the 2 ranks"):
        check_mesh_shape((3,), 2)
    with pytest.raises(ValueError, match=r"hp.mesh_shape=\(2,\)"):
        create_mesh((2,))        # one process
    check_mesh_shape((), 2)
    check_mesh_shape((2,), 2)
