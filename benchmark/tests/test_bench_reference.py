"""The plain reference against the port's own CPU paths at a tiny size, on
the benchmark's weights: the module path (the fused flags off) and the
kernels' plain versions (the recipe's flags), free-running and fed the
port's served frames; and the stop-token bias that keeps every step
decoding, on the port and on the reference."""

import pytest
import torch

from harness import serve
from harness.spec import HERE, load_module
from harness.weights import make_weights
from tiny import tiny_config

REF = load_module(HERE / "reference" / "tacotron_codes.py", "reference")
TOL = 1e-6   # float32 arithmetic in another order, over 24 steps


def _serve(config, seed, fused, stop_bias):
    config = dict(config, hparams=dict(
        config["hparams"], decoder_fused_inference=fused,
        encoder_fused_inference=fused))
    weights = make_weights(serve.model_shapes(config), seed, "cpu",
                           stop_bias=stop_bias)
    return serve.Server(config, weights, torch.device("cpu")), weights


def _request(hp, T, speaker, seed):
    gen = torch.Generator().manual_seed(seed)
    source = torch.randint(1, hp["num_symbols"], (T,), generator=gen)
    return source, speaker


SPEAKERS = pytest.mark.parametrize("speakers", [False, True],
                                   ids=["codes", "speakers"])


@SPEAKERS
@pytest.mark.parametrize("fused", [False, True])
def test_reference_matches_the_port(speakers, fused):
    config = tiny_config(speakers)
    server, weights = _serve(config, 2**31 + 11, fused,
                             config["stop_token_bias"])
    hp = server.hp.values()
    ref = REF.make(weights, hp)
    served_rows, requests = [], []
    for T, seed in ((5, 1), (13, 2)):
        source, speaker = _request(hp, T, 2 if speakers else None, seed)
        out = server.model(server.Batch(
            source=source[None], source_length=torch.tensor([T]),
            speaker_id=None if speaker is None else torch.tensor([speaker])))
        served = out.outputs
        assert int(out.lengths[0]) == hp["max_iters"]
        fed, fed_stop = ref([source], served.shape[1], [speaker],
                            feed=served)
        free, free_stop = ref([source], served.shape[1], [speaker])
        assert float((fed - served).abs().max()) < TOL
        assert float((free - served).abs().max()) < TOL
        for stop in (fed_stop, free_stop):
            assert float((stop - out.stop_token[:, :, 0]).abs().max()) < TOL
        assert float(served.abs().max()) > 100 * TOL
        served_rows.append(served[0])
        requests.append((source, speaker))
    # the checked calls run through the reference together, as rows of
    # one batch of sources padded to the longest
    rows, _ = ref([s for s, _ in requests], hp["max_iters"],
                  [k for _, k in requests], feed=torch.stack(served_rows))
    assert float((rows - torch.stack(served_rows)).abs().max()) < TOL


@SPEAKERS
def test_stop_bias_keeps_every_step_decoding(speakers):
    config = tiny_config(speakers)
    cap = config["hparams"]["max_iters"]
    # the opposite bias makes every step's stop fire: the port then stops
    # at the first step it allows, through the same path
    for bias, stops_early in ((config["stop_token_bias"], False),
                              (-config["stop_token_bias"], True)):
        server, weights = _serve(config, 5, True, bias)
        hp = server.hp.values()
        source, speaker = _request(hp, 9, 1 if speakers else None, 3)
        out = server.model(server.Batch(
            source=source[None], source_length=torch.tensor([9]),
            speaker_id=None if speaker is None else torch.tensor([speaker])))
        _, stop = REF.make(weights, hp)([source], cap, [speaker])
        assert bool((stop > 0).all()) == stops_early
        assert bool((stop < 0).all()) != stops_early
        first = hp["decoder_min_iters"] + 2
        assert int(out.lengths[0]) == (first if stops_early else cap)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11,
                      1.0 + 3 * 2**-12, -3.14159])
    got = REF.round_tf32(x)
    assert got.tolist()[:4] == [1.0, 1.0, 1.0 + 2**-9, 1.0 + 2**-10]
    assert abs(got[4] + 3.14159) < 2**-9 * 4
    assert (REF.round_tf32(got) == got).all()
