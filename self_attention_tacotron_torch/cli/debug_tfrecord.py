"""A TFRecord dump: every record's features, and its typed views.

The port of the JAX package's ``cli/debug_tfrecord.py`` (the reference's
``debug_tfrecord.py``): each file's records, their features (text fields
decoded, other bytes by size), then the source, code-target and
mel-target views where a record's schema matches.  numpy and the port's
record readers only; no device.

    python -m self_attention_tacotron_torch.cli.debug_tfrecord FILE [FILE ...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def describe(example: dict) -> str:
    from ..data import records as R
    lines = []
    for name, (kind, values) in sorted(example.items()):
        if kind == "bytes":
            v = values[0]
            if name in ("key", "text", "phone_txt", "lang"):
                lines.append(f"  {name}: {v.decode('utf-8', 'replace')!r}")
            else:
                lines.append(f"  {name}: <{len(v)} bytes>")
        else:
            lines.append(f"  {name}: {values}")
    # the typed views where the schema matches
    try:
        src = R.parse_source_record(example)
        lines.append(f"  [source view] len={src.source_length} "
                     f"speaker={src.speaker_id} text={src.text!r}")
    except (KeyError, TypeError):
        pass
    try:
        tgt = R.parse_code_target_record(example)
        ids = np.argmax(tgt.codes, axis=1)
        lines.append(f"  [codes view] T={tgt.codes_length} "
                     f"W={tgt.codes_width} ids[:10]={ids[:10].tolist()}")
    except (KeyError, TypeError):
        pass
    try:
        tgt = R.parse_mel_target_record(example)
        lines.append(f"  [mel view] T={tgt.target_length} W={tgt.mel_width} "
                     f"range=[{tgt.mel.min():.2f},{tgt.mel.max():.2f}]")
    except (KeyError, TypeError):
        pass
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("files", nargs="+")
    args = p.parse_args(argv)
    from ..data.tfrecord import read_examples
    for path in args.files:
        print(f"== {path}")
        for i, example in enumerate(read_examples(path)):
            print(f" record {i}:")
            print(describe(example))
    return 0


if __name__ == "__main__":
    sys.exit(main())
