"""A run with its timed path broken underneath comes out not correct: the
harness skips its look for a chip and runs a tiny cell on the CPU, where
the port's kernels take their plain versions, with ``fused_decode``
patched to break what it returns: a code logit or a stop logit altered
where #2 makes it, a step repeating the state before it, a decode that
stops early, a stop head whose product is left out.  Batch 1 on one chip
has no half batch to leave out and no exchange between chips."""

import pytest
import torch

import run
from self_attention_tacotron_torch.ops import fused_decode as fd
from tiny import tiny_cell, tiny_config


def _run(speakers, seed=2**32 + 9, cell=None):
    cell = cell or tiny_cell(speakers)
    return run.execute(cell, seed, 0.3, False, torch.device("cpu"),
                       log=lambda *a, **k: None)


def _broken(break_outputs):
    plain = fd.fused_decode

    def patched(*args, **kwargs):
        out, stop, aligns = plain(*args, **kwargs)
        out, stop = out.clone(), stop.clone()
        break_outputs(out, stop)
        return out, stop, aligns
    patched.launches = plain.launches
    return patched


def _altered_token(out, stop):
    out[:, 7, 3] += 0.01


def _unchanged_state(out, stop):
    out[:, 1:] = out[:, :1]


def _stops_early(out, stop):
    stop[:, 12:] = 1.0


def _altered_stop(out, stop):
    stop[:, 7] += 0.01


def _stop_product_left_out(out, stop):
    # the stop head's bias alone, as a decoder that skips its product
    stop.fill_(tiny_config()["stop_token_bias"])


SPEAKERS = pytest.mark.parametrize("speakers", [False, True],
                                   ids=["codes", "speakers"])


@SPEAKERS
def test_sound_run_is_correct(speakers):
    result = _run(speakers)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@SPEAKERS
@pytest.mark.parametrize("fault,number", [
    (_altered_token, "logit_gap"), (_unchanged_state, "logit_gap"),
    (_stops_early, "short_calls"), (_altered_stop, "stop_gap"),
    (_stop_product_left_out, "stop_gap")])
def test_broken_timed_path_is_not_correct(monkeypatch, speakers, fault,
                                          number):
    monkeypatch.setattr(fd, "fused_decode", _broken(fault))
    result = _run(speakers)
    assert not result["correct"]
    c = result["checks"][number]
    assert c["value"] > c["limit"]
