"""The traffic generator: the same seed gives the same requests, every seed
the same lengths block by block, ids and speakers in range."""

import itertools

import numpy as np

from harness.spec import HERE, load_json, load_module

GEN = load_module(HERE / "traffic" / "serve_closed.py", "traffic")
HP = {"num_symbols": 256, "speaker_embedding_offset": 0}
# a long mix with speakers, as a multi-speaker cell would give it
LONG = {"kind": "serve_closed", "clients": 1, "batch": 1,
        "source_length": [150, 750], "grid": 25, "speakers": 4}


def _take(mix, seed, n):
    return list(itertools.islice(GEN.requests(mix, HP, seed), n))


def test_same_seed_same_requests():
    mix = LONG
    a, b = _take(mix, 2**33 + 1, 60), _take(mix, 2**33 + 1, 60)
    assert [r.speaker for r in a] == [r.speaker for r in b]
    assert all(np.array_equal(x.source, y.source) for x, y in zip(a, b))
    c = _take(mix, 2**33 + 2, 60)
    assert any(not np.array_equal(x.source, y.source) for x, y in zip(a, c))


def test_every_seed_sends_the_same_lengths_a_block():
    mix = load_json(HERE / "traffic" / "b1_24-120.json")
    grid = GEN.grid(mix)
    assert list(grid) == list(range(24, 121))
    for seed in (0, 7, 2**32 + 3):
        reqs = _take(mix, seed, 2 * len(grid))
        for block in (reqs[:len(grid)], reqs[len(grid):]):
            assert sorted(r.source.shape[0] for r in block) == list(grid)
        assert all(1 <= r.source.min() and r.source.max() < 256
                   for r in reqs)
        assert all(r.speaker is None for r in reqs)


def test_speakers_and_grid_of_the_long_mix():
    mix = LONG
    grid = GEN.grid(mix)
    assert grid[0] == 150 and grid[-1] == 750 and len(grid) == 25
    reqs = _take(mix, 5, 200)
    assert {r.speaker for r in reqs} == {0, 1, 2, 3}
    warm = GEN.warmup(mix, HP, 5)
    assert [r.source.shape[0] for r in warm] == [750, 150, 750, 150]
