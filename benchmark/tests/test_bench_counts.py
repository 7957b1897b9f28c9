"""The kernel counts against the numbers ``chip_smoke.py`` logged for the
same shapes (phase 8, codes widths, B = 1, T = 64, 450 steps) and against
its decode bound with a speaker row (the codes widths with the SIWIS
recipe's 4-speaker row, 3000 steps)."""

import pytest

from harness.spec import HERE, load_json, load_module

COUNTS = {p: load_module(HERE / "counts" / f"{p}.py", "count")
          for p in ("fused_encode", "fused_decode", "attention_keys")}


def _hp(config, **changes):
    from harness.serve import hparams
    c = load_json(HERE / "configs" / f"{config}.json")
    return hparams(dict(c, hparams=dict(c["hparams"], **changes))).values()


@pytest.mark.parametrize("kernel,call,want", [
    ("fused_decode", dict(T=64, steps=450, rows=1), (12505824, 2510784000)),
    ("fused_encode", dict(T=64), (14429312, 457179136)),
    ("fused_decode", dict(T=120, steps=450, rows=1), (12829392, 2597169600)),
    ("fused_encode", dict(T=750), (15922048, 5423424000)),
])
def test_counts_reproduce_chip_smoke_codes(kernel, call, want):
    assert COUNTS[kernel].count(_hp("codes"), call) == want


@pytest.mark.parametrize("T,want", [(150, (26792124, 21933768000)),
                                    (750, (42498924, 28104168000))])
def test_decode_count_with_speaker_row(T, want):
    hp = _hp("codes", use_speaker_embedding=True, num_speakers=4,
             speaker_embedding_offset=0, max_iters=3000)
    got = COUNTS["fused_decode"].count(hp, dict(T=T, steps=3000, rows=1))
    assert got == want


def test_count_files_declare_symbols_operands_library_and_counter():
    for name, mod in COUNTS.items():
        assert isinstance(mod.SYMBOLS, tuple), name
        assert mod.OPERANDS in load_json(HERE / "peaks.json")["flop_per_s"]
        # a count with kernel symbols names the library and counter of
        # the program's kernel; one of plain work names neither
        assert (mod.LIBRARY is None) == (mod.COUNTER is None) == (
            not mod.SYMBOLS), name
    assert COUNTS["attention_keys"].count(
        _hp("codes"), dict(T=10, rows=1))[1] == 2 * 10 * (256 * 224 + 32 * 32)
