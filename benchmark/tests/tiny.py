"""A cell of the benchmark at widths a CPU test holds: the codes recipe
with every width and the step cap cut down, its traffic two short source
lengths.  The harness runs it on the CPU, where the port's kernels take
their plain versions."""

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import Cell, load_json  # noqa: E402

TINY = dict(embedding_dim=16, encoder_prenet_out_units=[16, 8],
            cbhg_out_units=16, conv_channels=4, max_filter_width=3,
            projection1_out_channels=8, projection2_out_channels=8,
            num_highway=2, self_attention_out_units=8,
            attention1_out_units=12, attention2_out_units=8,
            attention_out_units=16, decoder_prenet_out_units=[16, 8],
            decoder_out_units=16, decoder_self_attention_out_units=16,
            num_mels=33, max_iters=24, num_symbols=40, attention_kernel=4,
            attention_filters=3)


# the speaker row of a multi-speaker recipe (the SIWIS codes recipe's 4
# speakers at offset 0), on the same model
SPEAKERS = dict(use_speaker_embedding=True, num_speakers=4,
                speaker_embedding_offset=0)


def tiny_config(speakers: bool = False, **changes) -> dict:
    config = load_json(BENCH / "configs" / "codes.json")
    config["hparams"] = dict(config["hparams"], **TINY,
                             **(SPEAKERS if speakers else {}), **changes)
    return config


def tiny_cell(speakers: bool = False, mix=None, limits=None,
              sample: int = 2, **changes) -> Cell:
    """``codes_b1`` at the tiny widths; ``limits`` default to 1e-5 each."""
    from harness.spec import load_module
    benchmark = load_json(ROOT / "BENCHMARK.json")
    params = load_json(BENCH / "workloads" / "codes_b1.json")
    mix = mix or {"kind": "serve_closed", "clients": 1, "batch": 1,
                  "source_length": [5, 9], "grid": 3,
                  "speakers": 4 if speakers else 0}
    counts = {c: load_module(BENCH / "counts" / f"{c}.py", "count")
              for c in params["counts"]}
    limits = limits or {k: 1e-5 for k in params["limits"]}
    return Cell(name="codes_b1", chips=1,
                config=tiny_config(speakers, **changes),
                mix=json.loads(json.dumps(mix)),
                params=dict(params, sample=sample, limits=dict(limits)),
                end_to_end=benchmark["end_to_end"],
                per_layer=benchmark["per_layer"], counts=counts)
